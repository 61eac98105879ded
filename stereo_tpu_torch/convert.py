"""State carried across from the JAX package, as numpy arrays.

Build the port's solver problem, its ``DispMapNCC``, its
``DispMapGlobalStereo`` or its ``SecondOrderStereo`` from arrays the JAX
package produced (``np.asarray`` of them), so that both packages compute
the same thing from the same state — e.g. inject the JAX NCC volume and
assignment to compare the fusion moves apart from volume building.
Nothing of the JAX package is imported here, nor ml_dtypes: bfloat16
messages cross through their bits.
"""

from __future__ import annotations

import numpy as np
import torch

from stereo_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from stereo_tpu_torch.models.global_stereo import DispMapGlobalStereo
from stereo_tpu_torch.models.ncc import DispMapNCC
from stereo_tpu_torch.models.second_order import SecondOrderStereo
from stereo_tpu_torch.utils.checkpoint import to_numpy


def _as(a, dtype, dev):
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)


def _is_bf16_bits(a: np.ndarray) -> bool:
    """A 2-byte dtype numpy has no float for: the JAX package's bfloat16
    (``np.asarray`` of it: ml_dtypes' type, kind ``V``) or the ``|V2`` its
    checkpoints store it as."""
    return a.dtype.kind == "V" and a.dtype.itemsize == 2


def messages_from_numpy(messages, dtype=None, device=DEFAULT_DEVICE):
    """Messages of the JAX package (anything ``np.asarray`` takes) as a
    tensor on ``device``: bfloat16 ones through their bits (numpy has no
    bfloat16 of its own, and ``torch.as_tensor`` refuses ml_dtypes'), then
    in ``dtype`` (None: bfloat16 for bfloat16 input, else the input's)."""
    a = np.asarray(messages)
    if _is_bf16_bits(a):
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        t = t.view(torch.bfloat16)
    else:
        t = torch.as_tensor(a)
    return t.to(device=resolve_device(device),
                dtype=t.dtype if dtype is None else dtype)


def messages_to_numpy(messages) -> np.ndarray:
    """The inverse: a message tensor on the host, a bfloat16 one as its
    2-byte patterns (``|V2``, as a checkpoint of either package holds it;
    ``.view(ml_dtypes.bfloat16)`` of it is the JAX package's array)."""
    return to_numpy(messages)


def problem_from_numpy(unary, D0, Q, alphas, messages=None, *, dtype=None,
                       message_dtype=None, device=DEFAULT_DEVICE):
    """(unary [K,H,W], D0 [K,H,W], Q [4,K,H,W], alphas [4,H,W], messages
    [4,K,H,W] or None) as tensors on ``device``: the positional arguments of
    ``solvers.trws.solve`` plus the warm start.  ``dtype`` defaults to the
    unary's; the messages come in ``message_dtype``, which defaults to
    bfloat16 for the JAX package's bfloat16 messages (or a checkpoint's
    ``|V2``) and to ``dtype`` otherwise."""
    dev = resolve_device(device)
    if dtype is None:
        dtype = torch.as_tensor(np.asarray(unary)).dtype
    K, H, W = np.shape(unary)
    for name, a, shape in (("D0", D0, (K, H, W)), ("Q", Q, (4, K, H, W)),
                           ("alphas", alphas, (4, H, W))):
        if tuple(np.shape(a)) != shape:
            raise ValueError(f"{name}: shape {tuple(np.shape(a))}, expected "
                             f"{shape}")
    msgs = None
    if messages is not None:
        if tuple(np.shape(messages)) != (4, K, H, W):
            raise ValueError("messages: expected shape [4, K, H, W]")
        if message_dtype is None and not _is_bf16_bits(np.asarray(messages)):
            message_dtype = dtype
        msgs = messages_from_numpy(messages, message_dtype, dev)
    return (_as(unary, dtype, dev), _as(D0, dtype, dev), _as(Q, dtype, dev),
            _as(alphas, dtype, dev), msgs)



def batched_problem_from_numpy(unary, D0, Q, alphas, messages=None, *,
                               dtype=None, device=DEFAULT_DEVICE):
    """A batch of B problems ([B, K, H, W], [B, K, H, W], [B, 4, K, H, W],
    [B, 4, H, W] and optionally messages [B, 4, K, H, W]), e.g. the JAX
    package's parallel.batch.batched_problem, as stacked tensors on
    ``device``: the positional arguments of parallel.mesh.sharded_solve plus
    the warm start."""
    B = np.shape(unary)[0]
    pairs = [problem_from_numpy(
        unary[b], D0[b], Q[b], alphas[b],
        None if messages is None else messages[b], dtype=dtype,
        device=device) for b in range(B)]
    return tuple(None if pairs[0][j] is None
                 else torch.stack([p[j] for p in pairs])
                 for j in range(5))

def dispmap_ncc_from_numpy(images, disparities, kernel, unary_weight, tol,
                           ncc=None, assignment=None, smooth_weights=None,
                           *, device=DEFAULT_DEVICE, **kw):
    """A ``DispMapNCC`` on ``device`` from numpy state.

    ``ncc`` [D,H,W]: use this volume instead of building one; ``assignment``
    [4,H,W]: the incumbent plane field (the energy is recomputed);
    ``smooth_weights`` [4,H,W]: the directed-edge weights."""
    dm = DispMapNCC(images, disparities, kernel, unary_weight, tol, ncc=ncc,
                    device=device, **kw)
    if smooth_weights is not None:
        dm.smooth_weights = dm._tensor(smooth_weights)
    # setting the assignment recomputes the stored energy
    dm.assignment = dm.assignment if assignment is None else assignment
    return dm


def dispmap_global_from_numpy(images, P, disp_range, disparity_factor,
                              options=None, *, start_disparity=None,
                              segments=None, smooth_weights=None,
                              device=DEFAULT_DEVICE, **kw):
    """A ``DispMapGlobalStereo`` on ``device`` carrying numpy state.

    The model is built as usual, then takes ``start_disparity`` [H,W] (the
    random initial field's disparities), ``segments`` [H,W] (the
    segmentation its smoothness weights come from; the weights are
    recomputed from it) or ``smooth_weights`` [4,H,W] (used as they are),
    and restarts, so its stored energy is that of the carried state.
    ``options`` is the port's ``CVPR08Options`` (None: the defaults)."""
    if segments is not None and smooth_weights is not None:
        raise ValueError("pass segments or smooth_weights, not both")
    dm = DispMapGlobalStereo(images, P, disp_range, disparity_factor, options,
                             device=device, **kw)
    if segments is not None:
        dm._weights_from_segments(segments)
    if smooth_weights is not None:
        dm.smooth_weights = dm._tensor(smooth_weights)
    if start_disparity is not None:
        dm.start_disparity = dm._tensor(start_disparity)
    dm.restart()
    return dm


def second_order_from_numpy(images, P, disp_range, disparity_factor,
                            options=None, *, segments=None,
                            triple_weights=None, start=None, disp=None,
                            device=DEFAULT_DEVICE, **kw):
    """A ``SecondOrderStereo`` on ``device`` carrying numpy state.

    The model is built as usual, then takes ``segments`` [H,W] (its
    curvature weights are recomputed from them) or ``triple_weights`` (one
    [H,W] map per clique direction, used as they are), ``start`` [H,W] (the
    random start field, ``_start``) and ``disp`` [H,W] (the current field;
    None: the start).  ``options`` is the port's ``CVPR08Options``."""
    if segments is not None and triple_weights is not None:
        raise ValueError("pass segments or triple_weights, not both")
    m = SecondOrderStereo(images, P, disp_range, disparity_factor, options,
                          device=device, **kw)
    if segments is not None:
        m._weights_from_segments(segments)
    if triple_weights is not None:
        m._set_triple_weights(triple_weights)
    if start is not None:
        m._start = np.asarray(start, np.float64)
    m.disp = m._field(m._start if disp is None else disp)
    return m


def banded_state_from_numpy(state, *, dtype=None, device=DEFAULT_DEVICE):
    """A banded solver state ``(MA, MB, (SxL, SxR, SyU, SyD))`` of the JAX
    package (``solvers.banded``; anything ``np.asarray`` takes) as contiguous
    tensors on ``device``: what ``solvers.banded.BandedRun.run`` and
    ``ops.banded_kernel.sweep_banded`` of this package take, for a problem
    of the same spec — so one package can warm-start from the other's
    messages.  ``dtype`` defaults to MA's."""
    dev = resolve_device(device)
    MA, MB, S = state
    if len(S) != 4:
        raise ValueError("banded state: expected four seam arrays")
    if dtype is None:
        dtype = torch.as_tensor(np.asarray(MA)).dtype
    if np.shape(MA) != np.shape(MB) or np.ndim(MA) != 4:
        raise ValueError("banded state: MA and MB must both be [T+2, 2, K, L]")
    as_t = lambda a: _as(a, dtype, dev).contiguous()
    return as_t(MA), as_t(MB), tuple(as_t(s) for s in S)


def banded_state_to_numpy(state):
    """The inverse: this package's banded state as numpy arrays, in the
    nesting the JAX package's ``solvers.banded`` functions take."""
    MA, MB, S = state
    to_np = lambda t: t.detach().cpu().numpy()
    return to_np(MA), to_np(MB), tuple(to_np(s) for s in S)


def wavefront_groups_from_numpy(groups, *, dtype=None, device=DEFAULT_DEVICE):
    """A raster-wavefront message state ``(MA, MB)`` of the JAX package
    (``solvers.wavefront.messages_to_groups``; anything ``np.asarray`` takes)
    as contiguous tensors on ``device``: what
    ``ops.wavefront_kernel.sweep_wavefront`` and
    ``solvers.wavefront.decode_raster`` of this package take, for a problem
    of the same size.  ``dtype`` defaults to MA's."""
    dev = resolve_device(device)
    MA, MB = groups
    if dtype is None:
        dtype = torch.as_tensor(np.asarray(MA)).dtype
    if (np.shape(MA) != np.shape(MB) or np.ndim(MA) != 4
            or np.shape(MA)[1] != 2):
        raise ValueError("wavefront groups: MA and MB must both be "
                         "[T+2, 2, K, H]")
    return _as(MA, dtype, dev).contiguous(), _as(MB, dtype, dev).contiguous()


def wavefront_groups_to_numpy(groups):
    """The inverse: this package's ``(MA, MB)`` as numpy arrays."""
    MA, MB = groups
    return MA.detach().cpu().numpy(), MB.detach().cpu().numpy()
