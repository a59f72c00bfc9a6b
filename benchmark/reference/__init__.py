"""The plain reference that decides `correct`: plain PyTorch in float32
with TF32 off, written from the published models and the program's
documented semantics, importing nothing of the program, of the JAX
package or of JAX.  It reads the weight files the benchmark wrote and
the draws (boxes, augmentation parameters, motion scalars) that the
window's feed produced, and works out everything else again: the start
state from the seed, the text embeddings, the cut matrices, the
augmentation's warps, the decode, the tower, the loss and Adam.

`Precision` puts the control in the program's place: the parts the
program computes in bf16 (cut, warp, tower, VQGAN decoder) in fp8 with a
per-tensor scale, and its float32 parts in bf16."""
