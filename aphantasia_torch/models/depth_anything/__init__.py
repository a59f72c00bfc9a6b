"""Depth-Anything-V2, DINOv2 trunk and DPT head (counterpart of
aphantasia_tpu.models.depth_anything).  Weights convert from HF
`AutoModelForDepthEstimation` checkpoints (`convert.convert_hf_dav2`);
without one they are random from a seed."""
from aphantasia_torch.models.depth_anything.dpt import (
    DAV2_CONFIGS, DAV2Config, InferDepthAny, dav2_apply, dav2_init)
