"""Multi-device and multi-host runs (counterpart of aphantasia_tpu.parallel):
`mesh` (the data and model axes on torch.distributed, and the rank
launcher), `multihost` (fleets of independent jobs) and `dcn` (one data
axis over the ranks of several hosts)."""
