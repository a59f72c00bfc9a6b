"""aphantasia_torch — the PyTorch/CUDA port of aphantasia_tpu.

The module tree mirrors the JAX package, so each module here has a
counterpart of the same name there.  Plain tensor code is PyTorch; every
Pallas kernel on the ported path is a CUDA kernel written by hand for
Hopper (`csrc/`), built with nvcc at first use and loaded with ctypes
(`kernels.py`).  The package imports neither JAX nor aphantasia_tpu.

Entry points run on the CUDA device unless the caller asks for the CPU
(`device="cpu"`, `--device cpu`); without a GPU they raise.  On a CPU tensor
a kernel wrapper runs its plain PyTorch version, which is what the CPU tests
compare against the JAX package.

Subpackages
-----------
params    FFT spectrum parameterizer and color head
ops       cutout sampler, cutout and attention kernels, augmentations,
          losses, optimizers
models    the CLIP ViT towers and the tokenizer
cli       clip_fft, illustra, interpol, illustrip, depth, cppn, clip_vqgan
io        .pt snapshots, frames and video
parallel  the data, model and spatial mesh axes (the sharded canvases),
          fleets and the DCN data axis on torch.distributed
"""

__version__ = "0.1.0"
