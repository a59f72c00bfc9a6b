"""Multi-device and multi-host runs (counterpart of aphantasia_tpu.parallel):
`mesh` (the data, model and spatial axes on torch.distributed, and the
rank launcher), `spatial` and `spatial_dwt` (the canvases sharded over
the spatial axis), `multihost` (fleets of independent jobs) and `dcn`
(one data axis over the ranks of several hosts)."""
