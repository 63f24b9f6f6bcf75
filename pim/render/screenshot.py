"""Screenshot pipeline: exposure -> GT tonemap -> sRGB -> dither -> PNG.

Replicates CmdScreenshot (ref: src/rendering/render_system.c:680-745):
GT tonemap with m=0.5, exact sRGB inverse EOTF, 1/255 dither toward a
uniform random image, vertical flip on write.  The PNG encoder is a minimal
stdlib-zlib implementation (the stb_image_write counterpart).
"""

from __future__ import annotations

import os
import struct
import zlib

import jax.numpy as jnp
import numpy as np

from pim.core import rng
from pim.math.color import gt_tonemap, srgb_oetf


_TMAP_FIT_CACHE = {}


def fitted_gt_coeffs(whitepoint: float = 1.0):
    """Rational-curve fit of the GT tonemap (the cubic_fit consumer; ref
    cubic_fit.h's TMap model is exactly this use case: replace a
    transcendental tonemap with a 5-coeff rational).  Fit once per
    whitepoint, cached host-side; measured rms ~2e-3 over [0, 4P]."""
    key = round(float(whitepoint), 6)
    if key not in _TMAP_FIT_CACHE:
        from pim.math.cubic_fit import curve_fit

        xs = jnp.linspace(0.0, 4.0 * whitepoint, 256)
        ys = gt_tonemap(xs, P=whitepoint, a=1.0, m=0.5, l=0.4, c=1.33, b=0.0)
        coeffs, err = curve_fit(xs, ys, kind="tmap", iterations=600,
                                population=128, seed=7)
        _TMAP_FIT_CACHE[key] = (coeffs, float(err))
    return _TMAP_FIT_CACHE[key][0]


def tonemap_for_display(light, exposure, whitepoint: float = 1.0,
                        use_fit: bool = None):
    """HDR [N, 3] (or [H, W, 3]) -> display-referred [0,1] rgb.

    Matches the screenshot chain (GT tonemap params P=1, a=1, m=0.5, l=0.4,
    c=1.33, b=0) minus the dither (applied at quantization time).
    use_fit (cvar r_tonemap_fit) swaps in the cached rational fit
    (fitted_gt_coeffs) — the reference's cubic_fit trade of a cheap curve
    for the exp/pow tonemap.
    """
    if use_fit is None:
        from pim.core.cvars import cv_r_tonemap_fit

        use_fit = bool(cv_r_tonemap_fit.get())
    v = light * exposure
    v = jnp.maximum(v, 0.0)
    if use_fit:
        from pim.math.cubic_fit import tmap_eval

        v = jnp.clip(tmap_eval(v, fitted_gt_coeffs(whitepoint)), 0.0,
                     whitepoint)
    else:
        v = gt_tonemap(v, P=whitepoint, a=1.0, m=0.5, l=0.4, c=1.33, b=0.0)
    return srgb_oetf(v)


def quantize_dithered(srgb, seed: int = 0x5C4EE):
    """[H, W, 3] in [0,1] -> uint8 with the reference's 1/255 lerp dither."""
    h, w = srgb.shape[:2]
    state = rng.make_state(jnp.arange(h * w, dtype=jnp.uint32), 0, seed=seed)
    _, (nr, ng, nb) = rng.next_f32x3(state)
    noise = jnp.stack([nr, ng, nb], axis=-1).reshape(h, w, 3)
    v = srgb + (noise - srgb) * (1.0 / 255.0)
    return np.asarray(jnp.clip(v * 255.0 + 0.5, 0.0, 255.0).astype(jnp.uint8))


def write_png(path: str, rgb8: np.ndarray, flip_vertical: bool = True) -> None:
    """Minimal RGB(A)8 PNG writer (stdlib only)."""
    arr = np.asarray(rgb8, np.uint8)
    if arr.ndim == 2:
        arr = arr[..., None].repeat(3, axis=-1)
    if flip_vertical:
        arr = arr[::-1]
    h, w = arr.shape[:2]
    channels = arr.shape[2]
    color_type = {1: 0, 3: 2, 4: 6}[channels]

    def chunk(tag: bytes, data: bytes) -> bytes:
        c = tag + data
        return struct.pack(">I", len(data)) + c + struct.pack(">I", zlib.crc32(c))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    raw = b"".join(b"\x00" + arr[y].tobytes() for y in range(h))
    png = (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(png)


def read_png(path: str) -> np.ndarray:
    """Minimal PNG reader for round-trip tests (8-bit, no interlace)."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos = 8
    idat = b""
    w = h = channels = 0
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            w, h, depth, ctype, *_ = struct.unpack(">IIBBBBB", body)
            channels = {0: 1, 2: 3, 6: 4}[ctype]
        elif tag == b"IDAT":
            idat += body
        elif tag == b"IEND":
            break
    raw = zlib.decompress(idat)
    stride = w * channels
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ft = raw[y * (stride + 1)]
        line = np.frombuffer(raw[y * (stride + 1) + 1 : (y + 1) * (stride + 1)], np.uint8).copy()
        if ft == 0:
            pass
        elif ft == 1:  # sub
            for x in range(channels, stride):
                line[x] = (int(line[x]) + int(line[x - channels])) & 0xFF
        elif ft == 2:  # up
            line = (line.astype(np.int32) + prev).astype(np.uint8)
        elif ft == 3:  # average
            for x in range(stride):
                left = int(line[x - channels]) if x >= channels else 0
                line[x] = (int(line[x]) + ((left + int(prev[x])) >> 1)) & 0xFF
        elif ft == 4:  # paeth
            for x in range(stride):
                a = int(line[x - channels]) if x >= channels else 0
                b = int(prev[x])
                c = int(prev[x - channels]) if x >= channels else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                line[x] = (int(line[x]) + pred) & 0xFF
        out[y] = line
        prev = line
    return out.reshape(h, w, channels)
