"""Multi-pair batched simultaneous fusion over a device mesh (port of
stereo_tpu/parallel/batch.py).

The "high-res multi-pair batch" configuration: B same-shaped stereo problems
on the mesh's 'batch' rows, each pair's pixel grid partitioned over its row's
'x' shards (parallel/mesh.py) — data parallelism and spatial partitioning
composed.
"""

from __future__ import annotations

import sys
import traceback
from collections import deque

import numpy as np
import torch

from stereo_tpu_torch.parallel import mesh as mesh_mod


def batched_problem(models, proposals_per_model):
    """Stack B models' simultaneous-fusion inputs.

    models: same-shaped DispMap instances; proposals_per_model: list of lists
    of [4, H, W] proposals (equal K per model; the incumbent is appended).
    Returns (unary [B,K,H,W], D0 [B,K,H,W], Q [B,4,K,H,W], alphas [B,4,H,W],
    prop_stacks [B,K,4,H,W]), on the first model's device."""
    shapes = {m.sz for m in models}
    if len(shapes) != 1:
        raise ValueError(
            f"batched fusion needs same-shaped problems, got sizes "
            f"{sorted(shapes)}")
    parts = [dm.simultaneous_problem(props)
             for dm, props in zip(models, proposals_per_model)]
    dev = parts[0][0].device
    return tuple(torch.stack([p[i].to(dev) for p in parts])
                 for i in range(5))


def _take_labels(stack, labels):
    """The plane field a labeling selects: stack [K,4,H,W], labels [H,W]."""
    labels = labels.to(stack.device)
    idx = labels[None, None].long().expand(1, *stack.shape[1:])
    return torch.gather(stack, 0, idx)[0]


def simultaneous_fusion_batched(models, proposals_per_model, mesh,
                                maxiter=1000, max_relgap=1e-4,
                                compact=None):
    """Fuse B problems at once across the mesh; updates each model in place.

    Returns a list of (energy, lower_bound, iterations)."""
    kernel = models[0].smoothness_kernel
    tol = models[0].tol
    if any(m.smoothness_kernel != kernel for m in models):
        raise ValueError("batched fusion needs one smoothness kernel")
    unary, D0, Q, alphas, stacks = batched_problem(models,
                                                   proposals_per_model)
    res = mesh_mod.sharded_solve(
        mesh, unary, D0, Q, alphas, kernel=kernel, tol=tol, maxiter=maxiter,
        max_relgap=max_relgap, compact=compact)
    out = []
    for b, dm in enumerate(models):
        dm.assignment = _take_labels(stacks[b], res.labels[b])
        out.append((float(res.energy[b]), float(res.lower_bound[b]),
                    int(res.iterations[b])))
    return out


def simultaneous_fusion_pool(models, proposals_per_model, mesh, *,
                             maxiter=1000, max_relgap=1e-4, check_every=50,
                             max_retries=1, on_progress=None,
                             compact=None):
    """Production multi-pair pool: per-pair convergence and eviction.

    A fixed pool of B = mesh 'batch'-axis slots runs chunks of
    ``check_every`` sweeps; after each chunk, pairs whose relgap (E - lb)/E
    has met ``max_relgap`` (or whose sweep budget is spent) are *evicted* —
    labels written back into their model, the slot refilled from the pending
    queue with fresh (zero) messages — so N > B pairs stream through the
    mesh and pairs finish at different iteration counts.  The live slots of
    a chunk go to the mesh rows in slot order; idle slots cost nothing (no
    padding to B, as a fixed jit shape needs in the JAX package).

    Failure-graceful like the reference's fusion loop
    (ojw_stereo_optim.m:116-127): a chunk that raises is retried on the same
    devices up to ``max_retries`` times (transient failures); a persistent
    failure ends the run gracefully, every model keeping its current
    incumbent, and unfinished pairs reported with status "failed".

    Returns a list of dicts (one per input pair, input order):
    {"energy", "lower_bound", "iterations", "status"} with status in
    {"converged", "maxiter", "failed", "pending"}."""
    B = mesh.shape["batch"]
    n = len(models)
    if len(proposals_per_model) != n:
        raise ValueError("one proposal list per model required")
    shapes = {m.sz for m in models}
    ks = {len(p) for p in proposals_per_model}
    if len(shapes) != 1 or len(ks) != 1:
        raise ValueError("pooled fusion needs same-shaped problems and "
                         "equal proposal counts")
    kernel = models[0].smoothness_kernel
    tol = models[0].tol
    if any(m.smoothness_kernel != kernel for m in models):
        raise ValueError("pooled fusion needs one smoothness kernel")

    pending = deque(range(n))
    results = [{"energy": None, "lower_bound": None, "iterations": 0,
                "status": "pending"} for _ in range(n)]
    problems = {}

    def load(i):
        if i not in problems:
            problems[i] = models[i].simultaneous_problem(
                proposals_per_model[i])
        return problems[i]

    K = len(proposals_per_model[0]) + 1
    H, W = models[0].sz

    def fresh(i):
        prob = load(i)
        zero = torch.zeros((4, K, H, W), dtype=prob[0].dtype,
                           device=prob[0].device)
        return {"pair": i, "prob": prob, "msg": zero, "iters": 0}

    slots = [fresh(pending.popleft()) if pending else None
             for _ in range(B)]

    def finish(slot, e, lb, labels, status):
        i = slot["pair"]
        models[i].assignment = _take_labels(slot["prob"][4], labels)
        results[i] = {"energy": float(e), "lower_bound": float(lb),
                      "iterations": slot["iters"], "status": status}
        if on_progress:
            on_progress(i, results[i])

    while any(s is not None for s in slots):
        live = [s for s in slots if s is not None]
        dev = live[0]["prob"][0].device
        unary, D0, Q, alphas = (
            torch.stack([s["prob"][j].to(dev) for s in live])
            for j in range(4))
        msgs = torch.stack([s["msg"].to(dev) for s in live])

        res = None
        for attempt in range(max_retries + 1):
            try:
                res = mesh_mod.sharded_solve(
                    mesh, unary, D0, Q, alphas, kernel=kernel, tol=tol,
                    maxiter=check_every, max_relgap=max_relgap,
                    messages=msgs, check_every=check_every, compact=compact)
                energies = res.energy.cpu().numpy()  # waits for the chunk
                break
            except Exception as exc:  # transient failure: retry, then bail
                print(f"pooled fusion chunk failed "
                      f"(attempt {attempt + 1}/{max_retries + 1}): {exc!r}",
                      file=sys.stderr)
                if attempt == max_retries:
                    traceback.print_exc(file=sys.stderr)
                    for s in live:
                        results[s["pair"]] = {
                            "energy": s.get("last_e"),
                            "lower_bound": s.get("last_lb"),
                            "iterations": s["iters"], "status": "failed"}
                    return results
        lbs = res.lower_bound.cpu().numpy()
        iters = np.asarray(res.iterations)

        for k, s in enumerate(live):
            s["iters"] += int(iters[k])
            s["msg"] = res.messages[k]
            e, lb = float(energies[k]), float(lbs[k])
            s["last_e"], s["last_lb"] = e, lb
            relgap = (e - lb) / e if e else 0.0
            if relgap < max_relgap:
                finish(s, e, lb, res.labels[k], "converged")
            elif s["iters"] >= maxiter:
                finish(s, e, lb, res.labels[k], "maxiter")
            else:
                continue
            # evict: refill from the queue or idle the slot
            j = next(j for j, t in enumerate(slots) if t is s)
            slots[j] = fresh(pending.popleft()) if pending else None
    return results
