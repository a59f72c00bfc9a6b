"""The VQGAN decode alone (models/vqgan.py through the parameterizer's
`image`): its forward and latent gradient at the cell's size, in the
program's dtype, by graph replay, against the bound of its operations."""
from benchmark.harness import flops, timing


def read(lay: dict):
    import torch
    dec = lay["config"].get("vqgan")
    if dec is None:
        return None
    par = lay["par"]
    h, w = lay["size"]
    f = 2 ** (len(dec["ch_mult"]) - 1)
    gen = torch.Generator(device="cuda").manual_seed(7)
    z = torch.randn((1, dec["z_channels"], h // f, w // f), generator=gen,
                    device="cuda")
    co = torch.randn((1, 3, h, w), generator=gen, device="cuda")

    def fn():
        x = z.detach().requires_grad_(True)
        return torch.autograd.grad(par.image(x), x, co)[0]
    ms = timing.graph_ms(fn, iters=3)
    conv, attn = flops.vqgan_ops(dec, h, w)
    bound = timing.bound_ms(flops.vqgan_grad_bytes(dec, h, w),
                            2 * conv + 3 * attn, "bf16")
    return 100.0 * bound / ms
