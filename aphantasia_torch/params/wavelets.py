"""Wavelet filter banks in numpy (the port's own copy of
aphantasia_tpu.params.wavelets; no pywt):

* Daubechies dbN: spectral factorization of the maxflat half-band
  polynomial (exact to machine precision, any N)
* Symlets symN: the same polynomial, least-asymmetric root selection
* Coiflets coif1..coif5: published coefficient tables
* haar == db1
* dmey: the discrete Meyer filter by frequency sampling (the classical
  62-tap construction)

Conventions follow pywt's orthogonal-wavelet layout:
  rec_lo = h, dec_lo = h[::-1], rec_hi = qmf(h), dec_hi = qmf(h)[::-1]
with qmf(h)[k] = (-1)^k h[L-1-k].
"""
from __future__ import annotations

import functools

import numpy as np


def _qmf(h: np.ndarray) -> np.ndarray:
    g = h[::-1].copy()
    g[1::2] = -g[1::2]
    return g


def daubechies(n: int) -> np.ndarray:
    """Scaling (rec_lo) filter of dbN, length 2N, sum = sqrt(2)."""
    if n == 1:
        return np.array([1.0, 1.0]) / np.sqrt(2.0)
    # P(y) = sum_k C(N-1+k, k) y^k ;  y = (1 - cos w)/2
    k = np.arange(n)
    from math import comb
    p = np.array([comb(n - 1 + i, i) for i in range(n)], dtype=np.float64)
    # roots of P in y, mapped to z via y = (2 - z - 1/z)/4  =>  quadratic per root
    y_roots = np.roots(p[::-1])
    z_roots = []
    for y in y_roots:
        # z^2 - (2 - 4y) z + 1 = 0
        b = 4.0 * y - 2.0
        zr = np.roots([1.0, b, 1.0])
        # keep the root inside the unit circle (minimum phase)
        z_roots.append(zr[np.argmin(np.abs(zr))])
    # h(z) = c (1+z)^N * prod (z - z_i)
    poly = np.array([1.0 + 0j])
    for _ in range(n):
        poly = np.convolve(poly, [1.0, 1.0])
    for z in z_roots:
        poly = np.convolve(poly, [1.0, -z])
    h = np.real(poly)
    h *= np.sqrt(2.0) / h.sum()
    return h  # rec_lo orientation (pywt: db2 -> [0.4830, 0.8365, 0.2241, -0.1294])


def symlet(n: int) -> np.ndarray:
    """Least-asymmetric Daubechies variant: pick roots alternating inside/
    outside the unit circle to minimize phase nonlinearity (standard symN
    construction; sym2==db2)."""
    if n <= 3:
        return daubechies(n)
    from math import comb
    p = np.array([comb(n - 1 + i, i) for i in range(n)], dtype=np.float64)
    y_roots = np.roots(p[::-1])
    # sort roots; alternate selection of z inside/outside for symmetry
    pairs = []
    for y in y_roots:
        b = 4.0 * y - 2.0
        zr = np.roots([1.0, b, 1.0])
        zin = zr[np.argmin(np.abs(zr))]
        pairs.append(zin)
    # group complex-conjugate pairs; flip alternate conjugate groups outside
    chosen = []
    used = np.zeros(len(pairs), bool)
    flip = False
    for i, z in enumerate(pairs):
        if used[i]:
            continue
        used[i] = True
        group = [z]
        for j in range(i + 1, len(pairs)):
            if not used[j] and abs(pairs[j] - np.conj(z)) < 1e-8:
                used[j] = True
                group.append(pairs[j])
        if abs(z.imag) > 1e-10 and flip:
            group = [1.0 / np.conj(g) for g in group]
        if abs(z.imag) > 1e-10:
            flip = not flip
        chosen.extend(group)
    poly = np.array([1.0 + 0j])
    for _ in range(n):
        poly = np.convolve(poly, [1.0, 1.0])
    for z in chosen:
        poly = np.convolve(poly, [1.0, -z])
    h = np.real(poly)
    h *= np.sqrt(2.0) / h.sum()
    return h


# Coiflet scaling filters (rec_lo), standard published tables
_COIF = {
    1: [-0.0156557281354645, -0.0727326195128539, 0.3848648468642029,
        0.8525720202122554, 0.3378976624578092, -0.0727326195128539],
    2: [-0.000720549445364512, -0.0018232088707029932, 0.0056114348193944995,
        0.023680171946334084, -0.0594344186464569, -0.0764885990783064,
        0.41700518442169254, 0.8127236354455423, 0.3861100668211622,
        -0.06737255472196302, -0.04146493678175915, 0.016387336463522112],
    3: [-3.459977283621256e-05, -7.098330313814125e-05, 0.0004662169601128863,
        0.0011175187708906016, -0.0025745176887502236, -0.00900797613666158,
        0.015880544863615904, 0.03455502757306163, -0.08230192710688598,
        -0.07179982161931202, 0.42848347637761874, 0.7937772226256206,
        0.4051769024096169, -0.06112339000267287, -0.0657719112818555,
        0.023452696141836267, 0.007782596427325418, -0.003793512864491014],
    4: [-1.7849850030882614e-06, -3.2596802368833675e-06, 3.1229875865345646e-05,
        6.233903446100713e-05, -0.00025997455248771324, -0.0005890207562443383,
        0.0012665619292989445, 0.003751436157278457, -0.00565828668661072,
        -0.015211731527946259, 0.025082261844864097, 0.03933442712333749,
        -0.09622044203398798, -0.06662747426342504, 0.4343860564914685,
        0.782238930920499, 0.41530840703043026, -0.05607731331675481,
        -0.08126669968087875, 0.026682300156053072, 0.016068943964776348,
        -0.0073461663276420935, -0.0016294920126017326, 0.0008923136685823146],
    5: [-9.517657273819165e-08, -1.6744288576823017e-07, 2.0637618513646814e-06,
        3.7346551751414047e-06, -2.1315026809955787e-05, -4.134043227251251e-05,
        0.00014054114970203437, 0.00030225958181306315, -0.0006381313430451114,
        -0.0016628637020130838, 0.0024333732126576722, 0.006764185448053083,
        -0.009164231162481846, -0.01976177894257264, 0.03268357426711183,
        0.0412892087501817, -0.10557420870333893, -0.06203596396290357,
        0.4379916261718371, 0.7742896036529562, 0.4215662066908515,
        -0.05204316317624377, -0.09192001055969624, 0.02816802897093635,
        0.023408156785839195, -0.010131117519849788, -0.004159358781386048,
        0.0021782363581090178, 0.00035858968789573785, -0.00021208083980379827],
}


def coiflet(n: int) -> np.ndarray:
    return np.asarray(_COIF[n], dtype=np.float64)


@functools.lru_cache()
def meyer_discrete(taps: int = 62) -> np.ndarray:
    """Discrete Meyer (dmey) scaling filter by frequency sampling of the
    Meyer auxiliary polynomial nu(x) = x^4(35 - 84x + 70x^2 - 20x^3)."""
    n = 1024
    w = np.fft.fftfreq(n) * 2 * np.pi

    def nu(x):
        x = np.clip(x, 0.0, 1.0)
        return x ** 4 * (35 - 84 * x + 70 * x ** 2 - 20 * x ** 3)

    # H(w) = sqrt(2) * PHI_hat(2w): passband |w|<pi/3, transition to 2pi/3
    aw = np.abs(w)
    h = np.zeros(n)
    h[aw <= np.pi / 3] = 1.0
    band = (aw > np.pi / 3) & (aw < 2 * np.pi / 3)
    h[band] = np.cos(np.pi / 2 * nu(3 * aw[band] / np.pi - 1))
    ht = np.real(np.fft.ifft(h * np.sqrt(2.0)))
    ht = np.fft.fftshift(ht)
    c = n // 2
    half = taps // 2
    f = ht[c - half: c + half]
    f = f / f.sum() * np.sqrt(2.0)
    return f


def wavelet_filters(name: str):
    """name -> (dec_lo, dec_hi, rec_lo, rec_hi), float64 numpy."""
    name = name.lower()
    if name == "haar":
        h = daubechies(1)
    elif name.startswith("db"):
        h = daubechies(int(name[2:]))
    elif name.startswith("sym"):
        h = symlet(int(name[3:]))
    elif name.startswith("coif"):
        h = coiflet(int(name[4:]))
    elif name == "dmey":
        h = meyer_discrete()
    else:
        raise ValueError(f"unknown wavelet: {name}")
    rec_lo = np.asarray(h, np.float64)
    rec_hi = _qmf(rec_lo)
    return rec_lo[::-1].copy(), rec_hi[::-1].copy(), rec_lo, rec_hi


def dwt_max_level(data_len: int, filter_len: int = 2) -> int:
    """pywt.dwt_max_level; the reference always computes maxlevel with db1
    (filter_len=2, image.py:35)."""
    if data_len < filter_len - 1 or filter_len < 2:
        return 0
    return int(np.log2(data_len / (filter_len - 1.0)))
