"""CLIP ViT towers in PyTorch (counterpart of aphantasia_tpu.models.clip)."""
