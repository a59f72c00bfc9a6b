"""The wavelet pyramid over the spatial axis: a halo-exchange inverse DWT
(counterpart of aphantasia_tpu.parallel.spatial_dwt).

The pyramid [Yl, Yh_1 (finest) .. Yh_J] (params/dwt.py's layout) is
sharded by rows over the 'spatial' axis for its `k_fine` finest levels,
which hold most of the parameters (a level has a quarter of the next
finer's), and every rank holds the coarse tail whole and reconstructs it
(a small, identical computation).  The gradients of the whole leaves are
summed over the group (`reduce_grads`): each rank's holds the share of
its own rows.

A sharded synthesis step along H: output row t of the upsampling
synthesis reads input rows [ceil((t-1)/2), floor((t+L-2)/2)], so with the
output shards twice the input shards each rank needs the first
floor(L/2) rows of its LOWER neighbour (the next rank), one exchange a
pass (`_Permute`; the last rank receives zeros, the dense path's boundary
padding), then `params/dwt.py:_idwt_axis` on the extended rows.  Along W
the dense step runs as it is.

The heights cascade: the deepest sharded level is padded to
mp[K] = m_K rounded up to n, and each finer container doubles,
mp[j-1] = 2 mp[j] (always at least the real 2 m_j - L + 1|2).  The pad
rows are exact zeros: the param pads start zero and get no gradient (no
real output row reads them), each level's synthesis output is masked to
its real rows, and the synthesis treats missing rows as zeros, as the
dense path's boundary does.  The image container is H' = 2 mp[1] rows.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from aphantasia_torch.params.dwt import _idwt_axis, dwt_shapes
from aphantasia_torch.params.wavelets import dwt_max_level, wavelet_filters
from aphantasia_torch.parallel.spatial import (SpatialCanvas, _Permute,
                                               _all_gather, _count, _pad_to)


def _idwt_rows_sharded(lo, hi, wave: str, halo: int, spar):
    """One H-axis synthesis step on the rank's rows [..., mloc, W] -> its
    output rows [..., 2 mloc, W] of the doubled container, with the first
    `halo` rows of lo and hi from the next rank (one exchange)."""
    n = spar.n
    if n == 1:
        return _idwt_axis(lo, hi, wave, axis=-2, n_out=2 * lo.shape[-2])
    edge = torch.stack([lo[..., :halo, :], hi[..., :halo, :]]).contiguous()
    got = _Permute.apply(edge, spar.group, n, spar.idx,
                         tuple(i + 1 if i + 1 < n else None
                               for i in range(n)))
    lo_ext = torch.cat([lo, got[0]], dim=-2)
    hi_ext = torch.cat([hi, got[1]], dim=-2)
    return _idwt_axis(lo_ext, hi_ext, wave, axis=-2, n_out=2 * lo.shape[-2])


class SpatialDWT(SpatialCanvas):
    """`params/dwt.py:DWTParameterizer` over the spatial axis (its level
    rescale, inverse DWT and Bessel contrast normalisation) with the
    `k_fine` finest levels sharded by rows.  `shard(params)` takes the
    canonical pyramid to the rank's part, `full(params)` gathers it back
    to the reference layout."""

    def __init__(self, size, wave: str, sharp: float, colors: float, mesh):
        self._init_mesh(size, colors, mesh)
        self.wave, self.sharp_level = wave, sharp
        # maxlevel computed with db1, as the reference does
        self.level = dwt_max_level(min(self.size))
        self.real_shapes = dwt_shapes(self.size, wave, self.level)
        self.halo = len(wavelet_filters(wave)[2]) // 2
        # the finest levels whose rows a rank can extend with one
        # neighbour's halo, with bounded waste (m >= 2 n halo)
        k = 0
        for j in range(1, self.level + 1):
            if self.real_shapes[j][3] >= self.n * 2 * self.halo:
                k = j
            else:
                break
        self.k_fine = k
        self.mp = {}
        if k:
            self.mp[k] = _pad_to(self.real_shapes[k][3], self.n)
            for j in range(k - 1, 0, -1):
                self.mp[j] = 2 * self.mp[j + 1]
            self.h_container = 2 * self.mp[1]
        else:
            self.h_container = _pad_to(self.size[0], self.n)

    def _sharded(self, j: int) -> bool:
        return 1 <= j <= self.k_fine

    def shard(self, params):
        """Canonical [Yl, Yh_1..Yh_J] -> the rank's part: the sharded
        levels padded to their containers and cut to the rank's rows, the
        others whole."""
        out = []
        for j, p in enumerate(params):
            p = torch.as_tensor(p, dtype=torch.float32)
            if self._sharded(j):
                p = F.pad(p, (0, 0, 0, self.mp[j] - p.shape[3]))
                m = self.mp[j] // self.n
                p = p[:, :, :, self.idx * m:(self.idx + 1) * m]
            out.append(p.contiguous().clone())
        return out

    @torch.no_grad()
    def full(self, params):
        """The canonical pyramid: the sharded levels gathered (in one
        all-gather) and cut back to their real rows."""
        fine = [p for j, p in enumerate(params) if self._sharded(j)]
        if not fine:
            return list(params)
        parts = _all_gather(torch.cat([p.reshape(-1) for p in fine]),
                            self.group, self.n)
        _count("sp_all_gather")
        out, k = list(params), 0
        for j, p in enumerate(params):
            if self._sharded(j):
                rows = [q[k:k + p.numel()].view_as(p) for q in parts]
                real = self.real_shapes[j][3]
                out[j] = torch.cat(rows, dim=3)[:, :, :, :real]
                k += p.numel()
        return out

    def reduce_grads(self, grads) -> None:
        """Sum the gradients of the whole leaves (Yl and the coarse tail)
        over the group, in place, in one all-reduce."""
        whole = [g for j, g in enumerate(grads) if not self._sharded(j)]
        if not whole:
            return
        flat = torch.cat([g.reshape(-1) for g in whole])
        torch.distributed.all_reduce(flat, group=self.group)
        _count("sp_all_reduce")
        k = 0
        for g in whole:
            g.copy_(flat[k:k + g.numel()].view_as(g))
            k += g.numel()

    def _scales(self):
        """The level rescale of params/dwt.py:dwt_scale from the real,
        unpadded shapes."""
        h0, w0 = self.real_shapes[1][3:5]
        return [((h0 * w0) / (s[3] * s[4])) ** (1.0 - self.sharp_level)
                for s in self.real_shapes[1:]]

    def _target(self, j: int):
        return (tuple(self.real_shapes[j - 1][3:5]) if j > 1
                else tuple(self.size))

    def decode_rows(self, params, shift=None):
        del shift  # the DWT decode takes no shift (params/dwt.py)
        h, w = self.size
        wave, scales = self.wave, self._scales()
        ll = params[0]
        # the coarse tail, whole on every rank (params/dwt.py:waverec2)
        for j in range(self.level, self.k_fine, -1):
            yh = params[j] * scales[j - 1]
            lh, hl, hh = yh[:, :, 0], yh[:, :, 1], yh[:, :, 2]
            th, tw = self._target(j)
            ll = ll[..., :lh.shape[-2], :lh.shape[-1]]
            lo_w = _idwt_axis(ll, lh, wave, axis=-2, n_out=th)
            hi_w = _idwt_axis(hl, hh, wave, axis=-2, n_out=th)
            ll = _idwt_axis(lo_w, hi_w, wave, axis=-1, n_out=tw)
        if self.k_fine:
            # the whole [1,3,m_K,w_K] -> this rank's rows of its container
            mp_k = self.mp[self.k_fine]
            ll = self.my_rows_of(F.pad(ll, (0, 0, 0, mp_k - ll.shape[-2])),
                                 mp_k)
            for j in range(self.k_fine, 0, -1):
                yh = params[j] * scales[j - 1]
                lh, hl, hh = yh[:, :, 0], yh[:, :, 1], yh[:, :, 2]
                th, tw = self._target(j)
                lo_w = _idwt_rows_sharded(ll, lh, wave, self.halo, self)
                hi_w = _idwt_rows_sharded(hl, hh, wave, self.halo, self)
                # rows past the level's real height zeroed: the dense
                # path crops there, and zeros feed the next level as its
                # boundary padding does
                lo_w = self._real(lo_w, th)
                hi_w = self._real(hi_w, th)
                ll = _idwt_axis(lo_w, hi_w, wave, axis=-1, n_out=tw)
        else:
            # too small to shard the synthesis: the rows of the whole image
            ll = self.my_rows(F.pad(ll, (0, 0, 0,
                                         self.h_container - ll.shape[-2])))
        img = self.normalize(ll)
        if self.h_container != h:
            # the pads are exact zeros; the mask also drops any rounding
            img = self._real(img, h)
        return img

    def my_rows_of(self, x, height: int):
        """The rank's rows of a `height`-row container."""
        m = height // self.n
        return x.narrow(-2, self.idx * m, m)
