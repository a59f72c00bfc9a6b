"""Motion for the video CLI (counterpart of aphantasia_tpu.motion): the
keyframe animation curves and the depth-driven 3D grid warp."""
