"""Second-order scalar-disparity stereo — the ojw_stereo pipeline core (port
of stereo_tpu/models/second_order.py).

The reference bundles (but its examples never call) Woodford's full CVPR'08
scalar-disparity stereo: a disparity value per pixel, a *triple-clique*
second-order smoothness prior over 3 consecutive pixels per row/column
(ojw_stereo.m:76-94 builds the clique index set; ibr_fuse_depths.m:166-187
evaluates the truncated second derivative for all 8 cur/proposal corner
combinations), optimized by QPBO fusion with the triple tables reduced to
pairwise + auxiliary nodes (vgg_qpbo.cxx:209-256).

    E(d) = sum_p sum_views U_{p,a}(d_p)   [or the visibility model below]
         + sum_{triples (p-,p,p+)} w_t * min(|d_{p-} - 2 d_p + d_{p+}|, tau)

with U the Woodford photoconsistency unary (ops/photo) on the scalar field's
fronto-parallel planes, summed over input views, and w_t the
segmentation-modulated weights of the center pixel's in-edges.  With
``options.visibility`` (the reference default), the per-view photo costs move
from the unary into the geometric visibility model of models/visibility.

Where the work runs: the images, the field, the unary and curvature maps,
the segmentation's mean-shift filter and the projections are float32 tensors
on ``device``; the fusion tables and the QPBO (cubic reduction) are float64
numpy on the host, as in the JAX package.  Divisions by a constant divide by
a 0-dim tensor on the data's device (a CUDA division by a Python number is
a multiplication by its reciprocal).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from stereo_tpu_torch import geometry
from stereo_tpu_torch.config import CVPR08Options
from stereo_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from stereo_tpu_torch.models import visibility
from stereo_tpu_torch.ops import photo
from stereo_tpu_torch.proposals import segmentation
from stereo_tpu_torch.proposals import segpln as segpln_mod
from stereo_tpu_torch.solvers import qpbo_host


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _triple_slices(H, W, dy, dx):
    """Center / minus / plus slices of the (p-o, p, p+o) triple for offset
    o = (dy, dx); the center range is the interior where all three pixels
    are in-bounds (ojw_stereo.m:78-86)."""
    ady, adx = abs(dy), abs(dx)

    def sl(oy, ox):
        return (slice(ady + oy, H - ady + oy),
                slice(adx + ox, W - adx + ox))

    return sl(0, 0), sl(-dy, -dx), sl(dy, dx)


def second_diff_map(disp: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """|d_{p-o} - 2 d_p + d_{p+o}| for clique offset o = (dy, dx); zero where
    the triple leaves the image."""
    H, W = disp.shape
    c, m, p = _triple_slices(H, W, dy, dx)
    out = torch.zeros_like(disp)
    out[c] = torch.abs(disp[m] - 2.0 * disp[c] + disp[p])
    return out


def curvature_map(disp: torch.Tensor, axis: int) -> torch.Tensor:
    """|d_{p-} - 2 d_p + d_{p+}| along rows (axis=1) or columns (axis=0);
    zero where the triple leaves the image."""
    return second_diff_map(disp, *((0, 1) if axis == 1 else (1, 0)))


class SecondOrderStereo:
    """Scalar-disparity model with the triple-clique curvature prior."""

    def __init__(self, images, P, disp_range, disparity_factor,
                 options: CVPR08Options | None = None, *, seed: int = 0,
                 device=DEFAULT_DEVICE):
        options = options or CVPR08Options()
        self.options = options
        self.device = resolve_device(device)
        self.images = [torch.as_tensor(_host(im), dtype=torch.float32,
                                       device=self.device) for im in images]
        H, W = self.images[0].shape[:2]
        self.sz = (H, W)
        self.P = np.asarray(P, dtype=np.float64)
        disps = np.arange(disp_range[0] * disparity_factor,
                          disp_range[1] * disparity_factor + 1, dtype=np.float64)
        self.d_min = float(disps.min())
        self.d_max = float(disps.max())
        self.d_step = self.d_max - self.d_min
        self.tau = float(options.disp_thresh)  # threshold on normalized d
        # clique offsets: row/col triples, plus both diagonals for connect=8
        # (ojw_stereo.m:82-86)
        self.triple_dirs = [(0, 1), (1, 0)]
        if options.connect == 8:
            self.triple_dirs += [(1, 1), (-1, 1)]
        seg = segmentation.mean_shift(
            _host(self.images[0]).astype(np.float64),
            int(options.seg_params[0]), float(options.seg_params[1]),
            int(options.seg_params[2]), device=self.device)
        self._weights_from_segments(seg)

        rng = np.random.default_rng(seed)
        self._start = rng.random((H, W)) * self.d_step + self.d_min
        self.disp = self._field(self._start)

    def _field(self, d) -> torch.Tensor:
        """A float32 [H, W] field on the model's device (float64 values
        round to nearest, as the JAX package's casts round them)."""
        if isinstance(d, torch.Tensor):
            return d.to(device=self.device, dtype=torch.float32)
        return torch.tensor(np.asarray(d), dtype=torch.float32,
                            device=self.device)

    def _scalar(self, x: float) -> torch.Tensor:
        return torch.tensor(x, dtype=torch.float32, device=self.device)

    def _weights_from_segments(self, seg):
        """Curvature weights from a segmentation [H, W]: lambda_h for cliques
        entirely inside one mean-shift segment, lambda_l across boundaries
        (ojw_stereo.m:108-112), scaled by num_in / (2 if 8-connect)
        (ojw_stereo.m:113)."""
        opts = self.options
        H, W = self.sz
        seg = np.asarray(seg)
        self.seg = seg
        scale = len(self.images) / (2.0 if opts.connect == 8 else 1.0)
        weights = []
        for dy, dx in self.triple_dirs:
            c, m, p = _triple_slices(H, W, dy, dx)
            w = np.zeros((H, W))
            same = (seg[m] == seg[c]) & (seg[p] == seg[c])
            w[c] = np.where(same, opts.lambda_h, opts.lambda_l) * scale
            weights.append(w)
        self._set_triple_weights(weights)

    def _set_triple_weights(self, weights):
        """One [H, W] center-weight map per clique direction: float64 on
        the host for the fusion tables, float32 on the device for the
        curvature map."""
        if len(weights) != len(self.triple_dirs):
            raise ValueError(f"{len(weights)} weight maps, expected "
                             f"{len(self.triple_dirs)}")
        self.triple_weights = [np.asarray(w, np.float64) for w in weights]
        self._w_dev = [self._field(w) for w in self.triple_weights]
        # row/col center-weight maps
        self.w_h = self._w_dev[0]
        self.w_v = self._w_dev[1]

    # ------------------------------------------------------------ energy
    def unary_map(self, disp: torch.Tensor) -> torch.Tensor:
        """Photoconsistency summed over all input views (visibility off)."""
        planes = geometry.plane_field_from_disparity(disp)
        u = None
        for a in range(1, len(self.images)):
            ua = photo.unary_cost(
                planes, self.images[0], self.images[a],
                torch.as_tensor(self.P[a], dtype=torch.float32,
                                device=self.device),
                self.options.col_thresh,
                d_min=self.d_min, d_step=max(self.d_step, 1.0),
            )
            u = ua if u is None else u + ua
        return u

    @property
    def occl_val(self) -> float:
        return self.options.occl_const + float(np.log(2.0))

    def _vis_terms(self, D1, D2):
        return visibility.build_visibility_terms(
            self._field(D1), self._field(D2), self.images[1:], self.P[1:],
            self.images[0], self.options.col_thresh, self.occl_val,
        )

    def _robust(self, a):
        """Truncated smoothness kernel on |second difference| a
        (ojw_stereo.m:122-130): kernel 1 = min(|F|, tau); kernel 2 =
        min(F^2, tau^2) with EW pre-divided by tau."""
        if self.options.smoothness_kernel == 2:
            return (torch.minimum(a * a, self._scalar(self.tau * self.tau))
                    / self._scalar(self.tau))
        return torch.minimum(a, self._scalar(self.tau))

    def _robust_np(self, a):
        if self.options.smoothness_kernel == 2:
            return np.minimum(a * a, self.tau * self.tau) / self.tau
        return np.minimum(a, self.tau)

    def smooth_map(self, disp: torch.Tensor) -> torch.Tensor:
        dn = (disp - self.d_min) / self._scalar(max(self.d_step, 1.0))
        total = torch.zeros_like(dn)
        for (dy, dx), w in zip(self.triple_dirs, self._w_dev):
            total = total + self._robust(second_diff_map(dn, dy, dx)) * w
        return total

    def energy(self) -> float:
        if self.options.visibility:
            terms = self._vis_terms(self.disp, self.disp)
            e_vis, _ = visibility.calc_vis_energy(
                terms, np.zeros(terms["tp"], np.int32))
            smooth = float(_host(self.smooth_map(self.disp))
                           .astype(np.float64).sum())
            return e_vis + smooth
        return _scalar_energy(self)

    def _fusion_triples(self, cur_n, prop_n):
        """Triple-clique tables of a fusion pair (normalized disparities).

        Returns (triples list for the solver, blocks for vectorized energy
        evaluation): the 8-entry truncated-second-derivative tables of
        ibr_fuse_depths.m:166-187 over every clique direction
        (row/column, plus both diagonals under connect=8)."""
        H, W = self.sz
        nid = np.arange(H * W).reshape(H, W)
        triples = []
        blocks = []

        def add_triples(ids_a, ids_b, ids_c, w_center):
            vals = np.stack([
                np.stack([cur_n.ravel()[ids_a], prop_n.ravel()[ids_a]]),
                np.stack([cur_n.ravel()[ids_b], prop_n.ravel()[ids_b]]),
                np.stack([cur_n.ravel()[ids_c], prop_n.ravel()[ids_c]]),
            ])  # [3, 2, T]
            T = ids_a.shape[0]
            table = np.empty((2, 2, 2, T))
            for xa in range(2):
                for xb in range(2):
                    for xc in range(2):
                        d2 = np.abs(vals[0, xa] - 2 * vals[1, xb] + vals[2, xc])
                        table[xa, xb, xc] = self._robust_np(d2) * w_center
            blocks.append((ids_a, ids_b, ids_c, table))
            for t in range(T):
                triples.append((int(ids_a[t]), int(ids_b[t]), int(ids_c[t]),
                                table[:, :, :, t]))

        for (dy, dx), w in zip(self.triple_dirs, self.triple_weights):
            c, m, p = _triple_slices(H, W, dy, dx)
            add_triples(nid[m].ravel(), nid[c].ravel(), nid[p].ravel(),
                        np.asarray(w, np.float64)[c].ravel())
        return triples, blocks

    @staticmethod
    def _triples_energy(blocks, y):
        """Vectorized f64 energy of labeling y under the triple tables."""
        e = 0.0
        for ids_a, ids_b, ids_c, table in blocks:
            e += float(table[y[ids_a], y[ids_b], y[ids_c],
                             np.arange(len(ids_a))].sum())
        return e

    # ------------------------------------------------------------ fusion
    def _complete_labels(self, labels, regions, U0, U1, tails, heads, E,
                         triples):
        """Complete a partial QPBO labeling per ``options.improve`` — the
        reference's improve modes (ibr_fuse_depths.m:189-230):

        0: unlabelled keep current (all-zeros completion);
        1: QPBO-I from the keep-current completion (QPBOI-F);
        2: choose_labels per-region splice (QPBO-R);
        3: choose_labels all-0 vs all-1 (QPBO-L);
        4: QPBO-I seeded by the choose_labels splice (QPBOI-R, the
           callback at ibr_fuse_depths.m:195-197).
        """
        imp = int(self.options.improve)
        labels = np.asarray(labels)
        y0 = np.where(labels >= 0, labels, 0).astype(np.int32)
        if imp == 0 or (labels >= 0).all():
            return y0
        if imp in (2, 3):
            y, _ = qpbo_host.choose_labels(
                labels, regions, U0, U1, tails, heads, *E, triples=triples,
                mode=imp, independent=self.options.independent)
            return y.astype(np.int32)
        init = None
        if imp == 4:
            init, _ = qpbo_host.choose_labels(
                labels, regions, U0, U1, tails, heads, *E, triples=triples,
                mode=2, independent=self.options.independent)
        y, _ = qpbo_host.improve_with_triples(
            labels, U0, U1, tails, heads, *E, triples, init=init)
        return y.astype(np.int32)

    def fuse(self, proposal) -> float:
        """One QPBO fusion with triple cliques (and, per options.visibility,
        the geometric occlusion model); never increases energy.

        Records per-move stats in ``self.last_fuse_info`` — the analog of
        ibr_fuse_depths' stats.numbers [updated; unlabelled; regions] — with
        the seconds of the terms (``t_terms``) and of the solve
        (``t_solve``)."""
        H, W = self.sz
        tp = H * W
        t0 = time.perf_counter()
        cur = _host(self.disp).astype(np.float64)
        prop = _host(proposal).astype(np.float64)
        cur_n = (cur - self.d_min) / max(self.d_step, 1.0)
        prop_n = (prop - self.d_min) / max(self.d_step, 1.0)
        triples, blocks = self._fusion_triples(cur_n, prop_n)
        zeros = np.zeros(tp, np.int32)

        if self.options.visibility:
            terms = self._vis_terms(cur, prop)
            U0 = np.concatenate([terms["unary0"], terms["aux0"]])
            U1 = np.concatenate([terms["unary1"], terms["aux1"]])
            tails, heads, E00, E01, E10, E11 = terms["edges"]
            E = (E00, E01, E10, E11)
            t1 = time.perf_counter()
            labels, e, lb, n_unlab, regions = qpbo_host.solve_with_triples(
                U0, U1, tails, heads, *E, triples, regions=True,
            )
            y_full = self._complete_labels(labels, regions, U0, U1,
                                           tails, heads, E, triples)
            y = y_full[:tp].astype(np.int32)
            # consistent host-f64 guard with samples minimized out exactly
            e_move = (visibility.calc_vis_energy(terms, y)[0]
                      + self._triples_energy(blocks, y))
            e_keep = (visibility.calc_vis_energy(terms, zeros)[0]
                      + self._triples_energy(blocks, zeros))
            accept = e_move <= e_keep
            take = (y == 1) & accept
            self.last_fuse_info = {
                "updated": int(take.sum()), "unlabelled": int(n_unlab),
                "regions": int(len(np.unique(regions[regions >= 0]))),
                "t_terms": t1 - t0, "t_solve": time.perf_counter() - t1,
                "e_move": e_move, "e_keep": e_keep,
            }
            if accept:
                self.disp = self._field(
                    np.where(take.reshape(H, W), prop, cur))
                return e_move
            return e_keep

        U0 = _host(self.unary_map(self.disp)).astype(np.float64).ravel()
        U1 = _host(self.unary_map(self._field(prop))).astype(
            np.float64).ravel()
        ee = ([], [], [], [])
        t1 = time.perf_counter()
        labels, e, lb, n_unlab, regions = qpbo_host.solve_with_triples(
            U0, U1, [], [], *ee, triples, regions=True,
        )
        y = self._complete_labels(labels, regions, U0, U1, [], [], ee,
                                  triples)
        # Never-increase guard evaluated in ONE arithmetic: the solver's own
        # host-f64 energy of the all-zeros (keep-current) labeling, not the
        # device-f32 _scalar_energy (cross-precision disagreement could
        # otherwise accept marginally-worsening moves).
        e_cur = float(U0.sum()) + self._triples_energy(blocks, zeros)
        e_move = (float(np.where(y == 1, U1, U0).sum())
                  + self._triples_energy(blocks, y))
        accept = e_move <= e_cur
        take = (y == 1) & accept
        self.last_fuse_info = {
            "updated": int(take.sum()), "unlabelled": int(n_unlab),
            "regions": int(len(np.unique(regions[regions >= 0]))),
            "t_terms": t1 - t0, "t_solve": time.perf_counter() - t1,
            "e_move": e_move, "e_keep": e_cur,
        }
        if accept:
            self.disp = self._field(np.where(take.reshape(H, W), prop, cur))
        return self.energy()

    def restart(self, seed: int | None = None):
        """Reset the field to the initial random start, or to a freshly
        drawn one when ``seed`` is given (every ojw_stereo_optim call begins
        from a new random D, ojw_stereo_optim.m:61)."""
        if seed is not None:
            rng = np.random.default_rng(seed)
            self._start = rng.random(self.sz) * self.d_step + self.d_min
        self.disp = self._field(self._start)

    # --------------------------------------------------------- optimization
    def _proposal(self, kind, it, rng):
        """Materialize one schedule entry — the reference's fronto-parallel
        magic codes (ojw_stereo_optim.m:75-105) plus explicit arrays and
        callables ``f(it) -> entry``."""
        H, W = self.sz
        nd = max(int(round(self.d_step)) + 1, 2)
        if callable(kind):
            kind = kind(it)
        if isinstance(kind, str):
            if kind == "random":          # code 0
                Dnew = rng.random((H, W)) * self.d_step + self.d_min
            elif kind == "fronto":        # code 1
                Dnew = np.full((H, W), rng.random() * self.d_step + self.d_min)
            elif kind == "smooth":        # code 2
                dn = _host(self.disp).astype(np.float64) - self.d_min
                if it % 2:
                    dn[1:-1, :] = (dn[:-2, :] + dn[2:, :]) / 2
                else:
                    dn[:, 1:-1] = (dn[:, :-2] + dn[:, 2:]) / 2
                Dnew = dn + self.d_min
            elif kind == "sweep_ftb":     # code 3
                f = 1.0 - (it % nd) / (nd - 1)
                Dnew = np.full((H, W), f * self.d_step + self.d_min)
            elif kind == "sweep_btf":     # code -3
                f = (it % nd) / (nd - 1)
                Dnew = np.full((H, W), f * self.d_step + self.d_min)
            else:
                raise ValueError(f"unknown proposal kind {kind!r}")
        else:
            Dnew = _host(kind).astype(np.float64)
            if Dnew.ndim == 0:  # scalar → fronto-parallel plane
                Dnew = np.full((H, W), float(Dnew))
        # Dnew(~(Dnew>d_min)) = d_min (ojw_stereo_optim.m:110)
        return np.maximum(Dnew, self.d_min)

    def optimize(self, schedule=("fronto", "smooth", "random"),
                 max_iters: int | None = None, average_over: int | None = None,
                 converge: float | None = None, seed: int = 0,
                 verbose: bool = False, save_progress=None,
                 info: dict | None = None) -> list[float]:
        """Proposal-schedule fusion loop (ojw_stereo_optim.m:53-146).

        Schedule entries (the reference's fronto-parallel magic codes,
        :75-105): 'random' (code 0: uniform random field), 'fronto'
        (1: random constant), 'smooth' (2: current solution averaged over
        rows/columns, alternating), 'sweep_ftb'/'sweep_btf' (3/-3: ordered
        constant sweeps), an explicit [H, W] array or scalar, or a callable
        ``f(it)`` returning any of those.  Stops when the percentage energy
        decrease over ``average_over`` fusions drops below ``converge``
        (:64-67: thresholds scaled by 0.01 * average_over).

        ``save_progress``: optional callable invoked as
        ``save_progress(iteration, disp)`` (``disp`` a host numpy copy)
        after every fusion — the analog of save_progress(options.save_name,
        'D') (ojw_stereo_optim.m:134); exceptions from it are swallowed so a
        failing checkpoint sink cannot kill the solve.

        A fusion failure after the first iteration ends the loop gracefully
        with the current state (the try/catch at ojw_stereo_optim.m:116-127);
        a failure on the very first fusion re-raises.  A caller that must
        not carry on after a failure (a CUDA error included) passes ``info``
        and checks ``info["error"]``.

        If ``info`` is a dict it is filled with 'map' (iteration each pixel
        last changed), 'numbers' ([updated, unlabelled, regions] per iter),
        'timings' ([t_terms, t_solve] per iter), and 'error' (the swallowed
        exception, or None).

        Returns the energy trace.
        """
        opts = self.options
        max_iters = max_iters if max_iters is not None else opts.max_iters
        average_over = (average_over if average_over is not None
                        else opts.average_over)
        converge_thr = (converge if converge is not None
                        else opts.converge) * 0.01 * average_over
        rng = np.random.default_rng(seed)
        H, W = self.sz
        upd_map = np.zeros((H, W), np.int32)
        numbers, timings = [], []

        energies = [self.energy()]
        for it in range(max_iters):
            kind = schedule[it % len(schedule)]
            try:
                Dnew = self._proposal(kind, it, rng)
                prev_disp = _host(self.disp)
                e = self.fuse(Dnew)
            except Exception as exc:  # noqa: BLE001 — graceful-interrupt analog
                if it == 0:
                    raise
                if info is not None:
                    info["error"] = exc
                break
            changed = _host(self.disp) != prev_disp
            upd_map[changed] = it + 1
            fi = getattr(self, "last_fuse_info", {})
            numbers.append([fi.get("updated", int(changed.sum())),
                            fi.get("unlabelled", 0), fi.get("regions", 0)])
            timings.append([fi.get("t_terms", 0.0), fi.get("t_solve", 0.0)])
            energies.append(e)
            if save_progress is not None:
                try:
                    save_progress(it, _host(self.disp))
                except Exception:  # noqa: BLE001
                    pass
            if verbose:
                print(f"  iter {it} [{kind if isinstance(kind, str) else 'array'}]"
                      f": E = {e:.6g}")
            if len(energies) > average_over:
                prev = energies[-1 - average_over]
                if prev > 0 and 1.0 - energies[-1] / prev <= converge_thr:
                    break
        if info is not None:
            info.setdefault("error", None)
            info["map"] = upd_map
            info["numbers"] = np.asarray(numbers, np.int64).reshape(-1, 3)
            info["timings"] = np.asarray(timings, np.float64).reshape(-1, 2)
        return energies


def segpln_scalar_proposals(model: SecondOrderStereo, *, seed: int = 0,
                            window: int = 2) -> list[np.ndarray]:
    """Scalar-disparity SegPln proposal maps for the second-order model —
    the per-pixel own-pixel disparity of each fitted segment plane, the form
    ojw_segpln returns to ojw_stereo (ojw_stereo.m:158-160, a H×W×14 stack
    of disparity maps rather than plane fields).  The disparities are
    float64, clipped to the model's range."""
    ndisps = max(int(round(model.d_step)) + 1, 2)
    disparities = np.linspace(model.d_max, model.d_min, ndisps)
    planes = segpln_mod.segpln(
        model.images, [model.P[a] for a in range(len(model.images))],
        disparities, model.options.col_thresh, window=window, seed=seed,
        device=model.device,
    )
    out = []
    for p in planes:
        d = _host(geometry.own_disparity(torch.as_tensor(
            _host(p), dtype=torch.float64, device=model.device)))
        out.append(np.clip(d, model.d_min, model.d_max))
    return out


def ojw_stereo(images, P, disp_range, disparity_factor,
               options: CVPR08Options | None = None, *, seed: int = 0,
               verbose: bool = False, save_progress=None,
               device=DEFAULT_DEVICE):
    """The full second-order pipeline driver — proposal_method dispatch of
    ojw_stereo.m:144-192.

    ``options.proposal_method`` is a sequence of stage codes run in order,
    each a fresh optimize() over the shared model state:

      0: ordered fronto-parallel sweeps ('sweep_ftb');
      1: SameUni random fronto-parallel ('fronto');
      2: SegPln — the 14 segment-plane disparity maps, cycled;
      3: Smooth* — {D_segpln, D_sameuni, smooth ×4} cycle;
      4: Smooth — {D_current, smooth, smooth, ...}.

    Alternatively a fixed [N, H, W] proposal stack or a callable f(it)
    (ojw_stereo.m:182-190).  Returns (model, info) with per-stage energy
    traces under info['stages']; each stage's info carries its 'error'
    (None unless a fusion after the first failed).
    """
    options = options or CVPR08Options()
    model = SecondOrderStereo(images, P, disp_range, disparity_factor,
                              options, seed=seed, device=device)
    info: dict = {"stages": {}}
    method = options.proposal_method

    def run(name, schedule):
        stage_info: dict = {}
        es = model.optimize(schedule=schedule, seed=seed, verbose=verbose,
                            save_progress=save_progress, info=stage_info)
        stage_info["energy"] = es
        stage_info["D"] = _host(model.disp)
        info["stages"][name] = stage_info
        return es

    if isinstance(method, (tuple, list)) and all(
            isinstance(m, int) for m in method):
        results: dict = {}
        for idx, m in enumerate(method):
            if idx > 0:  # every optimize stage begins from a fresh random D
                model.restart(seed + idx)
            if m == 0:
                run("samedisc", ("sweep_ftb",))
                results[0] = _host(model.disp)
            elif m == 1:
                run("sameuni", ("fronto",))
                results[1] = _host(model.disp)
            elif m == 2:
                props = segpln_scalar_proposals(model, seed=seed)
                info["segpln_gen"] = len(props)
                run("segpln", [lambda it, p=props: p[it % len(p)]])
                results[2] = _host(model.disp)
            elif m == 3:
                d_seg = results.get(2, _host(model.disp))
                d_uni = results.get(1, _host(model.disp))
                run("smooth_star",
                    (d_seg, d_uni, "smooth", "smooth", "smooth", "smooth"))
            elif m == 4:
                d_cur = _host(model.disp)
                run("smooth", [lambda it, d=d_cur:
                               d if it == 0 else "smooth"])
            else:
                raise ValueError(f"unknown proposal_method code {m}")
    elif callable(method):
        run("udprop", [method])
    else:
        stack = _host(method).astype(np.float64)
        run("udprop", [lambda it, s=stack: s[it % len(s)]])
    return model, info


def _scalar_energy(model: SecondOrderStereo) -> float:
    """float32 sums of the unary and the curvature maps (the visibility-off
    energy)."""
    unary = model.unary_map(model.disp)
    smooth = model.smooth_map(model.disp)
    acc = torch.promote_types(unary.dtype, torch.float32)
    return float(unary.sum(dtype=acc) + smooth.sum(dtype=acc))
