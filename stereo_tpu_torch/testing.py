"""Input makers for tests and the on-device smoke run: numpy only, every
array from a seed, so the same inputs can be handed to this package and to
the JAX package."""

from __future__ import annotations

import numpy as np

DIRS = ((0, -1), (0, 1), (-1, 0), (1, 0))

# argument order of ops.phase_kernel.phase_messages_compact / phase_messages
# (the keys of phase_inputs / phase_inputs_full)
COMPACT_ARGS = ("gD_s", "gDn", "M_s", "M_o", "Q_s", "Q_o", "D0_s", "D0_o",
                "a_s", "a_o", "valid_s", "valid_o")
FULL_ARGS = ("gD", "gD_shifted", "M", "Q", "D0", "alphas", "src_is_head",
             "valid")


def border_weights(H: int, W: int, value=1.0, dtype=np.float64):
    """[4, H, W] directed-edge weights: ``value`` where the neighbour
    exists, 0 at the borders."""
    a = np.zeros((4, H, W), dtype)
    a[0, :, 1:] = value
    a[1, :, :-1] = value
    a[2, 1:, :] = value
    a[3, :-1, :] = value
    return a


def trws_problem(seed: int, K: int, H: int, W: int, dtype=np.float64,
                 alpha_scale: float = 1.0):
    """Random solver inputs with unrelated positions: theta [K,H,W],
    D0 [K,H,W], Q [4,K,H,W], alphas [4,H,W] (random in [0.5, 2) * scale,
    0 at borders)."""
    rng = np.random.default_rng(seed)
    theta = rng.uniform(0, 5, (K, H, W))
    D0 = rng.uniform(-3, 3, (K, H, W))
    Q = rng.uniform(-3, 3, (4, K, H, W))
    alphas = border_weights(H, W) * alpha_scale * rng.uniform(
        0.5, 2.0, (4, H, W))
    return tuple(a.astype(dtype) for a in (theta, D0, Q, alphas))


def synthetic_problem(K: int, H: int, W: int, seed: int = 0,
                      dtype=np.float32):
    """A fusion-like problem: neighbour positions are the own positions plus
    small noise, edge weight 9 (the shape of the packages' entry-point
    check)."""
    rng = np.random.default_rng(seed)
    theta = rng.uniform(0, 5, (K, H, W)).astype(dtype)
    D0 = rng.uniform(0, 10, (K, H, W)).astype(dtype)
    Q = (D0[None] + rng.normal(0, 0.1, (4, K, H, W))).astype(dtype)
    return theta, D0, Q, border_weights(H, W, 9.0, dtype)


def phase_inputs(seed: int, K: int, Hc: int, W: int, dtype=np.float32):
    """Random inputs of ``phase_messages_compact`` (a dict by argument name),
    border zeros in ``a_*`` / ``valid_*`` included."""
    rng = np.random.default_rng(seed)
    k3, k4, p3 = (K, Hc, W), (4, K, Hc, W), (4, Hc, W)
    out = dict(
        gD_s=rng.uniform(0, 2, k3), gDn=rng.uniform(0, 2, k4),
        M_s=rng.uniform(0, 1, k4), M_o=rng.uniform(0, 1, k4),
        Q_s=rng.uniform(-3, 3, k4), Q_o=rng.uniform(-3, 3, k4),
        D0_s=rng.uniform(-3, 3, k3), D0_o=rng.uniform(-3, 3, k3),
    )
    for c in "so":
        valid = (rng.uniform(0, 1, p3) > 0.15).astype(np.float64)
        valid[:, :, 0] = 0.0  # a border column
        out[f"a_{c}"] = rng.uniform(0.5, 2.0, p3) * valid
        out[f"valid_{c}"] = valid
    return {k: np.ascontiguousarray(v.astype(dtype)) for k, v in out.items()}


def phase_inputs_full(seed: int, K: int, H: int, W: int, color: int = 0,
                      dtype=np.float32):
    """Random inputs of ``phase_messages`` (a dict by argument name) with the
    checkerboard mask of ``color`` as ``src_is_head``."""
    rng = np.random.default_rng(seed)
    k3, k4 = (K, H, W), (4, K, H, W)
    valid = border_weights(H, W)
    ys, xs = np.mgrid[0:H, 0:W]
    out = dict(
        gD=rng.uniform(0, 2, k3), gD_shifted=rng.uniform(0, 2, k4),
        M=rng.uniform(0, 1, k4), Q=rng.uniform(-3, 3, k4),
        D0=rng.uniform(-3, 3, k3),
        alphas=rng.uniform(0.5, 2.0, (4, H, W)) * valid,
        src_is_head=((ys + xs) % 2 == color).astype(np.float64),
        valid=valid,
    )
    return {k: np.ascontiguousarray(v.astype(dtype)) for k, v in out.items()}


def negate_alphas(inp: dict, seed: int, share: float = 1 / 3) -> dict:
    """A copy of phase inputs (``phase_inputs`` / ``phase_inputs_full``) with
    the edge weights negated at a random ``share`` of the pixels, in every
    direction: the case in which a phase kernel may not hoist the
    truncation out of its loop."""
    out = dict(inp)
    keys = [k for k in ("a_s", "a_o", "alphas") if k in inp]
    flip = np.random.default_rng(seed).uniform(
        size=inp[keys[0]].shape[1:]) < share
    for k in keys:
        out[k] = np.ascontiguousarray(np.where(flip[None], -inp[k], inp[k]))
    return out


def send_inputs(seed: int, B: int, K: int, L: int, dtype=np.float32):
    """Random inputs of ``ops.minplus.minplus_send``: (hs, p, r [B, K, L],
    alpha [B, L])."""
    rng = np.random.default_rng(seed)
    out = (rng.uniform(0, 2, (B, K, L)), rng.uniform(-3, 3, (B, K, L)),
           rng.uniform(-3, 3, (B, K, L)), rng.uniform(0.5, 2.0, (B, L)))
    return tuple(np.ascontiguousarray(a.astype(dtype)) for a in out)


def pair_inputs(seed: int, K: int, H: int, W: int, dtype=np.float32):
    """Random inputs of ``ops.minplus.minplus_pair``: (H_A, H_B, P, R
    [K, H, W], alpha [H, W]); alpha is 0 on the first row and column, as a
    direction's weights are at the border."""
    rng = np.random.default_rng(seed)
    out = [rng.uniform(0, 2, (K, H, W)), rng.uniform(0, 2, (K, H, W)),
           rng.uniform(-3, 3, (K, H, W)), rng.uniform(-3, 3, (K, H, W))]
    alpha = rng.uniform(0.5, 2.0, (H, W))
    alpha[0, :] = 0.0
    alpha[:, 0] = 0.0
    return tuple(np.ascontiguousarray(a.astype(dtype)) for a in out + [alpha])


def textured_pair(seed: int, H: int, W: int, shift: int = 3,
                  noise: float = 2.0):
    """A random textured stereo pair [H, W, 3] x 2 (float64, values around
    [0, 255]): the reference view is the second one rolled by ``shift``
    columns plus noise, so NCC has an unambiguous peak at every pixel."""
    rng = np.random.default_rng(seed)
    im1 = rng.uniform(0, 255, (H, W, 3))
    im0 = np.roll(im1, shift, axis=1) + rng.normal(0, noise, (H, W, 3))
    return im0, im1


def random_planes(seed: int, H: int, W: int, dtype=np.float64):
    """A random plane field [4, H, W] with |c| >= 0.5."""
    rng = np.random.default_rng(seed)
    p = rng.standard_normal((4, H, W))
    p[2] = np.sign(p[2]) * (np.abs(p[2]) + 0.5)
    return p.astype(dtype)
