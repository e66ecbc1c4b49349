"""Deterministic synthetic datasets — a numpy copy of the JAX package's
digits and textures, so both packages see identical inputs.

 - digits: procedural 28x28 glyphs (MNIST stand-in) — each class is a fixed
   stroke pattern + random affine jitter + noise, so a CNN must genuinely
   learn shape features; exact-vs-approx deltas are the paper's claim.
 - images: procedural multi-scale textures for denoising (FFDNet stand-in).
 - tokens: zipf token streams with copy structure (the LM suite's data).
"""
from __future__ import annotations

import numpy as np

# --------------------------------------------------------------------- digits

_SEGS = {  # 7-segment-inspired strokes per digit on a 28x28 canvas
    0: [(4, 4, 24, 6), (4, 22, 24, 24), (4, 4, 6, 24), (22, 4, 24, 24)],
    1: [(12, 4, 16, 24)],
    2: [(4, 4, 24, 6), (18, 6, 24, 14), (4, 12, 24, 16), (4, 16, 8, 24),
        (4, 22, 24, 24)],
    3: [(4, 4, 24, 6), (4, 12, 24, 16), (4, 22, 24, 24), (20, 4, 24, 24)],
    4: [(4, 4, 8, 14), (4, 12, 24, 16), (18, 4, 22, 24)],
    5: [(4, 4, 24, 6), (4, 6, 8, 14), (4, 12, 24, 16), (18, 16, 24, 22),
        (4, 22, 24, 24)],
    6: [(4, 4, 24, 6), (4, 4, 8, 24), (4, 12, 24, 16), (18, 16, 24, 24),
        (4, 22, 24, 24)],
    7: [(4, 4, 24, 6), (16, 6, 22, 24)],
    8: [(4, 4, 24, 6), (4, 12, 24, 16), (4, 22, 24, 24), (4, 4, 8, 24),
        (20, 4, 24, 24)],
    9: [(4, 4, 24, 6), (4, 4, 8, 14), (4, 12, 24, 16), (20, 4, 24, 24),
        (4, 22, 24, 24)],
}


def digits(n: int, seed: int = 0):
    """(images (n,28,28,1) float32 in [0,1], labels (n,) int32)."""
    rng = np.random.default_rng(seed)
    imgs = np.zeros((n, 28, 28, 1), np.float32)
    labels = rng.integers(0, 10, n).astype(np.int32)
    yy, xx = np.mgrid[0:28, 0:28]
    for i in range(n):
        canvas = np.zeros((28, 28), np.float32)
        dx, dy = rng.integers(-3, 4, 2)
        sc = 1.0 + 0.15 * rng.standard_normal()
        for (x0, y0, x1, y1) in _SEGS[int(labels[i])]:
            cx, cy = 14, 14
            x0s = cx + (x0 - cx) * sc + dx
            x1s = cx + (x1 - cx) * sc + dx
            y0s = cy + (y0 - cy) * sc + dy
            y1s = cy + (y1 - cy) * sc + dy
            m = ((xx >= min(x0s, x1s)) & (xx <= max(x0s, x1s))
                 & (yy >= min(y0s, y1s)) & (yy <= max(y0s, y1s)))
            canvas[m] = 1.0
        canvas += 0.15 * rng.standard_normal((28, 28)).astype(np.float32)
        imgs[i, :, :, 0] = np.clip(canvas, 0, 1)
    return imgs, labels


# --------------------------------------------------------------------- images

def textures(n: int, size: int = 64, seed: int = 0):
    """(n, size, size, 1) float32 in [0,1]: smooth multi-scale fields with
    edges — plausible denoising targets."""
    rng = np.random.default_rng(seed)
    out = np.zeros((n, size, size, 1), np.float32)
    yy, xx = np.mgrid[0:size, 0:size] / size
    for i in range(n):
        img = np.zeros((size, size), np.float32)
        for octave in range(3):
            f = 2 ** octave
            a, b, c, d = rng.uniform(0, 2 * np.pi, 4)
            img += (np.sin(2 * np.pi * f * xx + a) *
                    np.cos(2 * np.pi * f * yy + b) +
                    np.sin(2 * np.pi * f * (xx + yy) + c)) / (2 ** octave)
        # sharp structure: random rectangles
        for _ in range(3):
            x0, y0 = rng.integers(0, size - 8, 2)
            w, h = rng.integers(4, size // 2, 2)
            img[y0:y0 + h, x0:x0 + w] += rng.uniform(-1, 1)
        img = (img - img.min()) / (img.max() - img.min() + 1e-9)
        out[i, :, :, 0] = img
    return out


def add_noise(images: np.ndarray, sigma: float, seed: int = 0):
    rng = np.random.default_rng(seed)
    noisy = images + (sigma / 255.0) * rng.standard_normal(
        images.shape).astype(np.float32)
    return np.clip(noisy, 0, 1).astype(np.float32)


# --------------------------------------------------------------------- tokens

def token_stream(n_seqs: int, seq_len: int, vocab: int, seed: int = 0):
    """Zipf tokens with local repetition structure (learnable bigrams)."""
    rng = np.random.default_rng(seed)
    base = rng.zipf(1.3, (n_seqs, seq_len)).astype(np.int64) % vocab
    # inject copy structure: token[t] sometimes repeats token[t-3]
    mask = rng.random((n_seqs, seq_len)) < 0.3
    shifted = np.roll(base, 3, axis=1)
    toks = np.where(mask, shifted, base)
    return toks.astype(np.int32)
