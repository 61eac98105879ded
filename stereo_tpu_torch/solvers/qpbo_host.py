"""Host QPBO (roof duality): the exact binary-fusion solver through the
port's native library (port of stereo_tpu/solvers/qpbo_host.py).

The rd.m / rd_mex.cpp equivalent: takes per-directed-edge fusion tables and
returns a strongly-persistent partial labeling, the energy of the
unlabelled-keep-current completion, the roof-dual lower bound, and the
unlabelled count.  numpy arrays in and out, on the host; the solver is the
port's own copy of ``qpbo.cpp`` (``native.lib("qpbo")``, built with the
host's C++ compiler at first use).
"""

from __future__ import annotations

import ctypes

import numpy as np

from stereo_tpu_torch import native


def solve(U0, U1, tails, heads, E00, E01, E10, E11, improve: bool = False,
          weak: bool = True, regions: bool = False):
    """Returns (labels [N] in {-1,0,1}, energy, lower_bound, n_unlabelled).

    ``weak``: extend the strongly-persistent labeling with weak persistency
    (ComputeWeakPersistencies equivalent; on by default like rd_mex.cpp:69).
    ``regions``: also return the per-node strongly-connected-region ids of
    the unlabelled nodes (the GetRegions analog feeding choose_labels,
    ibr_fuse_depths.m:287-375): int32 [N], region id in 0..R-1 for
    unlabelled nodes, -1 for labelled ones.
    """
    U0 = np.ascontiguousarray(U0, dtype=np.float64).ravel()
    U1 = np.ascontiguousarray(U1, dtype=np.float64).ravel()
    tails = np.ascontiguousarray(tails, dtype=np.int32).ravel()
    heads = np.ascontiguousarray(heads, dtype=np.int32).ravel()
    E00 = np.ascontiguousarray(E00, dtype=np.float64).ravel()
    E01 = np.ascontiguousarray(E01, dtype=np.float64).ravel()
    E10 = np.ascontiguousarray(E10, dtype=np.float64).ravel()
    E11 = np.ascontiguousarray(E11, dtype=np.float64).ravel()
    n = U0.shape[0]
    m = tails.shape[0]
    assert heads.shape[0] == m and U1.shape[0] == n
    assert all(x.shape[0] == m for x in (E00, E01, E10, E11))
    if m and (tails.min() < 0 or max(tails.max(), heads.max()) >= n):
        raise ValueError("edge endpoint out of range")

    labels = np.zeros(n, dtype=np.int32)
    energy = ctypes.c_double()
    lb = ctypes.c_double()
    n_unlab = ctypes.c_int32()

    L = native.lib("qpbo")
    f64p = ctypes.POINTER(ctypes.c_double)
    i32p = ctypes.POINTER(ctypes.c_int32)
    reg = np.zeros(n, dtype=np.int32) if regions else None
    rc = L.qpbo_solve(
        n, m,
        U0.ctypes.data_as(f64p), U1.ctypes.data_as(f64p),
        tails.ctypes.data_as(i32p), heads.ctypes.data_as(i32p),
        E00.ctypes.data_as(f64p), E01.ctypes.data_as(f64p),
        E10.ctypes.data_as(f64p), E11.ctypes.data_as(f64p),
        int(bool(improve)) | (0 if weak else 2),
        labels.ctypes.data_as(i32p),
        ctypes.byref(energy), ctypes.byref(lb), ctypes.byref(n_unlab),
        reg.ctypes.data_as(i32p) if regions else ctypes.cast(None, i32p),
    )
    if rc != 0:
        raise RuntimeError(f"qpbo_solve failed with code {rc}")
    out = (labels, float(energy.value), float(lb.value), int(n_unlab.value))
    if regions:
        return out + (reg,)
    return out


def solve_with_triples(U0, U1, tails, heads, E00, E01, E10, E11, triples,
                       improve: bool = False, weak: bool = True,
                       regions: bool = False):
    """QPBO with triple cliques — the vgg_qpbo capability
    (imrender/vgg/vgg_qpbo.cxx:209-256 reduces each 8-entry triple table to
    pairwise terms plus one auxiliary node; here via the Freedman-Drineas
    cubic reduction rather than the mex's regularity-projection code).

    triples: list of (i, j, k, table) with table[x_i, x_j, x_k] of shape
    (2, 2, 2).  Returns (labels [N] for the original variables, energy,
    lower_bound, n_unlabelled) where the reported energy is re-evaluated on
    the original energy (aux labels marginalized exactly).
    """
    U0_orig = np.asarray(U0, dtype=np.float64).ravel()
    U1_orig = np.asarray(U1, dtype=np.float64).ravel()
    U0 = U0_orig.copy()
    U1 = U1_orig.copy()
    n = len(U0)
    tails_orig = np.asarray(tails, dtype=np.int64).ravel()
    heads_orig = np.asarray(heads, dtype=np.int64).ravel()
    tails = list(tails_orig)
    heads = list(heads_orig)
    pe = [list(np.asarray(e, dtype=np.float64).ravel())
          for e in (E00, E01, E10, E11)]
    extra_u = []  # (node, du0, du1) — aux nodes appended after the n originals

    def add_pair(a, b, t00, t01, t10, t11):
        tails.append(a)
        heads.append(b)
        for lst, v in zip(pe, (t00, t01, t10, t11)):
            lst.append(v)

    def add_unary(i, w):  # energy w * x_i
        nonlocal U0, U1
        if i < n:
            U1[i] += w
        else:
            extra_u[i - n][2] += w

    n_aux = 0
    const = 0.0
    for (i, j, k, table) in triples:
        t = np.asarray(table, dtype=np.float64).reshape(2, 2, 2)
        # multilinear coefficients
        c0 = t[0, 0, 0]
        ci = t[1, 0, 0] - c0
        cj = t[0, 1, 0] - c0
        ck = t[0, 0, 1] - c0
        cij = t[1, 1, 0] - c0 - ci - cj
        cik = t[1, 0, 1] - c0 - ci - ck
        cjk = t[0, 1, 1] - c0 - cj - ck
        cijk = t[1, 1, 1] - c0 - ci - cj - ck - cij - cik - cjk
        const += c0
        add_unary(i, ci)
        add_unary(j, cj)
        add_unary(k, ck)
        if cij:
            add_pair(i, j, 0, 0, 0, cij)
        if cik:
            add_pair(i, k, 0, 0, 0, cik)
        if cjk:
            add_pair(j, k, 0, 0, 0, cjk)
        if cijk:
            w_id = n + n_aux
            n_aux += 1
            extra_u.append([w_id, 0.0, 0.0])
            a = cijk
            if a < 0:
                # a*x_i*x_j*x_k = min_w a*w*(x_i + x_j + x_k - 2):
                # three E11 pairwise terms a*w*x_. plus unary -2a*w
                extra_u[-1][2] += -2.0 * a
                add_pair(i, w_id, 0, 0, 0, a)
                add_pair(j, w_id, 0, 0, 0, a)
                add_pair(k, w_id, 0, 0, 0, a)
            else:
                # a*x_i*x_j*x_k = a*x_j*x_k - a*(1-x_i)*x_j*x_k; the second
                # term has a negative cubic coefficient in (1-x_i, x_j, x_k):
                # -a*(1-x_i)*x_j*x_k = min_w [-a*w*(1-x_i) - a*w*x_j
                #                             - a*w*x_k + 2a*w]
                add_pair(j, k, 0, 0, 0, a)
                extra_u[-1][2] += 2.0 * a
                add_pair(i, w_id, 0, -a, 0, 0)  # E01: -a*w*(1-x_i)
                add_pair(j, w_id, 0, 0, 0, -a)  # E11: -a*w*x_j
                add_pair(k, w_id, 0, 0, 0, -a)

    U0_full = np.concatenate([U0, [u[1] for u in extra_u]])
    U1_full = np.concatenate([U1, [u[2] for u in extra_u]])
    res = solve(
        U0_full, U1_full, tails, heads, *pe, improve=improve, weak=weak,
        regions=regions,
    )
    labels, e_raw, lb, n_unlab = res[:4]
    lb += const
    lab_orig = labels[:n]
    # energy of the keep-zero completion on the ORIGINAL energy
    y = np.where(lab_orig >= 0, lab_orig, 0)
    E = triples_energy(y, U0_orig, U1_orig, tails_orig, heads_orig,
                       E00, E01, E10, E11, triples)
    n_unlab = int((lab_orig < 0).sum())
    out = (lab_orig, E, lb, n_unlab)
    if regions:
        out = out + (res[4][:n],)
    return out


def triples_energy(lab, U0, U1, tails, heads, E00, E01, E10, E11, triples):
    """Energy of a 0/1 labeling under unary + pairwise + triple terms."""
    E = labeling_energy(lab, U0, U1, np.asarray(tails, dtype=np.int64),
                        np.asarray(heads, dtype=np.int64),
                        np.asarray(E00, dtype=np.float64),
                        np.asarray(E01, dtype=np.float64),
                        np.asarray(E10, dtype=np.float64),
                        np.asarray(E11, dtype=np.float64))
    for (i, j, k, table) in triples:
        t = np.asarray(table, dtype=np.float64).reshape(2, 2, 2)
        E += float(t[lab[i], lab[j], lab[k]])
    return E


def _triple_arrays(triples):
    """(A, B, C, tables[T,2,2,2]) from a triples list; empty arrays if none."""
    tl = list(triples)
    if not tl:
        z = np.zeros(0, np.int64)
        return z, z, z, np.zeros((0, 2, 2, 2), np.float64)
    A = np.array([t[0] for t in tl], np.int64)
    B = np.array([t[1] for t in tl], np.int64)
    C = np.array([t[2] for t in tl], np.int64)
    T = np.stack([np.asarray(t[3], np.float64).reshape(2, 2, 2) for t in tl])
    return A, B, C, T


def choose_labels(labels, regions, U0, U1, tails, heads, E00, E01, E10, E11,
                  triples=(), mode: int = 2, independent: bool = False):
    """Complete a QPBO partial labeling by splicing over its
    strongly-connected unlabelled regions — the reference's choose_labels
    (ibr_fuse_depths.m:287-375).

    ``labels``: [N] in {-1, 0, 1}; ``regions``: [N] region id for unlabelled
    nodes, -1 for labelled ones (from ``solve(..., regions=True)``).

    mode=3 (QPBO-L): whichever of the all-0 / all-1 completions of the
    unlabelled set has lower total energy.  mode=2 (QPBO-R): per-region
    choice — a region flips to 1 iff the sum of its incident cliques'
    (completion-1 − completion-0) deltas is negative.  With ``independent``
    regions are first merged along shared cliques so every flip decision is
    exact (the splice is then optimal over region flips); otherwise a clique
    spanning several regions attributes its delta to the lowest region id,
    as the reference does by default (ojw_default_options.m:78).

    Returns (y, n_regions): a complete 0/1 labeling and the number of
    (merged) regions considered.
    """
    labels = np.asarray(labels)
    U0 = np.asarray(U0, np.float64).ravel()
    U1 = np.asarray(U1, np.float64).ravel()
    tails = np.asarray(tails, np.int64).ravel()
    heads = np.asarray(heads, np.int64).ravel()
    E = [np.asarray(e, np.float64).ravel() for e in (E00, E01, E10, E11)]
    free = labels < 0
    y0 = np.where(free, 0, labels).astype(np.int64)
    if not free.any():
        return y0, 0
    y1 = np.where(free, 1, y0)
    if mode == 3:
        e0 = triples_energy(y0, U0, U1, tails, heads, *E, triples)
        e1 = triples_energy(y1, U0, U1, tails, heads, *E, triples)
        return (y1, 1) if e1 < e0 else (y0, 1)
    if mode != 2:
        raise ValueError(f"choose_labels mode must be 2 or 3, got {mode}")

    reg_in = np.asarray(regions, np.int64)
    # compact region ids over the free ORIGINAL nodes (ids owned solely by
    # reduction-auxiliary nodes may be absent from this view)
    uniq = np.unique(reg_in[free])
    R = len(uniq)
    nodereg = np.zeros(len(labels), np.int64)
    nodereg[free] = np.searchsorted(uniq, reg_in[free])

    A, B, C, TT = _triple_arrays(triples)

    if independent and R > 1:
        parent = np.arange(R)

        def find(a):
            while parent[a] != a:
                parent[a] = parent[parent[a]]
                a = parent[a]
            return a

        def union_pairs(pa, pb):
            for a, b in zip(pa, pb):
                ra, rb = find(a), find(b)
                if ra != rb:
                    parent[max(ra, rb)] = min(ra, rb)

        m = free[tails] & free[heads]
        union_pairs(nodereg[tails[m]], nodereg[heads[m]])
        for X, Y in ((A, B), (A, C), (B, C)):
            m = free[X] & free[Y]
            union_pairs(nodereg[X[m]], nodereg[Y[m]])
        roots = np.array([find(r) for r in range(R)])
        nodereg[free] = roots[nodereg[free]]
        n_regions = len(np.unique(roots))
    else:
        n_regions = R

    BIGREG = np.int64(R)  # sentinel above every region id for labelled nodes
    delta = np.zeros(R + 1, np.float64)

    # unary deltas
    np.add.at(delta, nodereg[free], (U1 - U0)[free])

    # pairwise deltas → lowest incident free region (exact after merging)
    if len(tails):
        anyf = free[tails] | free[heads]
        t_, h_ = tails[anyf], heads[anyf]
        Em = np.stack(E, 0)[:, anyf]
        ar = np.arange(len(t_))
        e0 = Em[2 * y0[t_] + y0[h_], ar]
        e1 = Em[2 * y1[t_] + y1[h_], ar]
        rr = np.minimum(np.where(free[t_], nodereg[t_], BIGREG),
                        np.where(free[h_], nodereg[h_], BIGREG))
        np.add.at(delta, rr, e1 - e0)

    # triple deltas likewise
    if len(A):
        anyf = free[A] | free[B] | free[C]
        a_, b_, c_ = A[anyf], B[anyf], C[anyf]
        Tm = TT[anyf]
        ar = np.arange(len(a_))
        e0 = Tm[ar, y0[a_], y0[b_], y0[c_]]
        e1 = Tm[ar, y1[a_], y1[b_], y1[c_]]
        rr = np.minimum(np.where(free[a_], nodereg[a_], BIGREG),
                        np.where(free[b_], nodereg[b_], BIGREG))
        rr = np.minimum(rr, np.where(free[c_], nodereg[c_], BIGREG))
        np.add.at(delta, rr, e1 - e0)

    flip = delta[:R] < 0.0
    y = y0.copy()
    y[free & flip[nodereg]] = 1
    return y, n_regions


def improve_with_triples(labels, U0, U1, tails, heads, E00, E01, E10, E11,
                         triples, rounds: int = 3, seed: int = 0, init=None):
    """QPBO-I at the triple-clique level (vals.improve modes 1/4,
    ibr_fuse_depths.m:191-197 — QPBOI-F runs from the keep-current
    completion, QPBOI-R from a choose_labels splice passed as ``init``).

    Each round pins a random half of the originally-unlabelled nodes to
    their current value via hard unaries, re-solves the reduced problem, and
    keeps the result iff the full triple-clique energy did not increase.
    Returns (y, energy) with y a complete 0/1 labeling over the original
    nodes.
    """
    U0 = np.asarray(U0, np.float64).ravel()
    U1 = np.asarray(U1, np.float64).ravel()
    labels = np.asarray(labels)
    n = len(U0)
    if init is not None:
        y = np.asarray(init, np.int64).ravel().copy()
        y[labels >= 0] = labels[labels >= 0]
    else:
        y = np.where(labels >= 0, labels, 0).astype(np.int64)
    free = labels < 0
    best_e = triples_energy(y, U0, U1, tails, heads, E00, E01, E10, E11,
                            triples)
    if not free.any():
        return y, best_e

    _, _, _, TT = _triple_arrays(triples)
    tmax = float(np.abs(TT).max()) if TT.size else 0.0
    scale = max(np.abs(U0).max(), np.abs(U1).max(), tmax, 1.0)
    BIG = 1e6 * scale * n
    rng = np.random.default_rng(seed)
    for _ in range(rounds):
        fix = free & (rng.random(n) < 0.5)
        u0 = U0.copy()
        u1 = U1.copy()
        u0[fix & (y == 1)] = BIG
        u1[fix & (y == 0)] = BIG
        lab, _, _, _ = solve_with_triples(u0, u1, tails, heads,
                                          E00, E01, E10, E11, triples)
        y_new = np.where(lab >= 0, lab, y)
        e_new = triples_energy(y_new, U0, U1, tails, heads,
                               E00, E01, E10, E11, triples)
        if e_new <= best_e:
            y, best_e = y_new, e_new
    return y, best_e


def improve(labels, U0, U1, tails, heads, E00, E01, E10, E11,
            rounds: int = 3, seed: int = 0, init=None):
    """QPBO-I (the rd_mex Improve path, rd_mex.cpp:91-92): randomized
    fix-and-resolve.

    Start from the keep-current completion y of a QPBO partial labeling.
    Each round fixes a random subset of the previously-unlabelled nodes to
    their value in y (via hard unaries), re-solves QPBO on the rest, and
    applies every labeled node onto y.  Because the fixed energy's strong
    persistency is an autarky and y satisfies the constraints, the energy is
    non-increasing; the symmetry-breaking lets rounds label nodes the plain
    roof dual could not.  Follows the scheme of Rother et al., "Optimizing
    Binary MRFs via Extended Roof Duality" (CVPR 2007), not Kolmogorov's code.

    ``init`` (optional [N] 0/1): starting completion for the unlabelled
    nodes instead of all-zeros — the seed produced by choose_labels in the
    reference's QPBOI-R mode (ibr_fuse_depths.m:195-197).

    Returns (y, energy) with y a complete 0/1 labeling.
    """
    U0 = np.asarray(U0, dtype=np.float64).ravel().copy()
    U1 = np.asarray(U1, dtype=np.float64).ravel().copy()
    labels = np.asarray(labels)
    if init is not None:
        y = np.asarray(init, dtype=np.int64).ravel().copy()
        y[labels >= 0] = labels[labels >= 0]
    else:
        y = np.where(labels >= 0, labels, 0).astype(np.int64)
    free = labels < 0
    if not free.any():
        return y, labeling_energy(y, U0, U1, tails, heads, E00, E01, E10, E11)

    scale = max(np.abs(U0).max(), np.abs(U1).max(), 1.0)
    BIG = 1e6 * scale * len(U0)
    rng = np.random.default_rng(seed)
    best_e = labeling_energy(y, U0, U1, tails, heads, E00, E01, E10, E11)
    for _ in range(rounds):
        fix = free & (rng.random(len(U0)) < 0.5)
        u0 = U0.copy()
        u1 = U1.copy()
        u0[fix & (y == 1)] = BIG
        u1[fix & (y == 0)] = BIG
        lab, _, _, _ = solve(u0, u1, tails, heads, E00, E01, E10, E11)
        y_new = np.where(lab >= 0, lab, y)
        e_new = labeling_energy(y_new, U0, U1, tails, heads, E00, E01, E10, E11)
        if e_new <= best_e:
            y, best_e = y_new, e_new
    return y, best_e


class _ParityUF:
    """Union-find with edge parities: x_i == x_root(i) XOR parity(i)."""

    def __init__(self, n):
        self.parent = np.arange(n)
        self.parity = np.zeros(n, np.int64)

    def find(self, i):
        root, p = i, 0
        while self.parent[root] != root:
            p ^= self.parity[root]
            root = self.parent[root]
        # path compression (second pass)
        j, q = i, p
        while self.parent[j] != j:
            nj = self.parent[j]
            nq = q ^ self.parity[j]
            self.parent[j] = root
            self.parity[j] = q
            j, q = nj, nq
        return int(root), int(p)

    def union(self, j, i, rel):
        """Impose x_j == x_i XOR rel.  Returns False if already related."""
        rj, pj = self.find(j)
        ri, pi = self.find(i)
        if rj == ri:
            return False
        # x_rj = x_j ^ pj = (x_i ^ rel) ^ pj = x_ri ^ (pi ^ rel ^ pj)
        self.parent[rj] = ri
        self.parity[rj] = pi ^ rel ^ pj
        return True


def _reduce_problem(U0, U1, tails, heads, E, uf, fixed):
    """Canonicalize the original energy under a set of fix/contract
    constraints: substitute x_i -> x_root ^ parity, fold fixed roots and
    self-loop edges into unaries/the constant.

    Returns (roots [list of active original root ids], U0r, U1r, tails_r,
    heads_r, E_r [4, M'], const) with endpoints indexing into ``roots``.
    """
    n = len(U0)
    root = np.empty(n, np.int64)
    par = np.empty(n, np.int64)
    for i in range(n):
        root[i], par[i] = uf.find(i)
    active = sorted({int(r) for r in root if fixed[r] < 0})
    idx = {r: k for k, r in enumerate(active)}
    na = len(active)
    U0r = np.zeros(na)
    U1r = np.zeros(na)
    const = 0.0

    for i in range(n):
        r, p = root[i], par[i]
        u0, u1 = (U0[i], U1[i]) if p == 0 else (U1[i], U0[i])
        if fixed[r] >= 0:
            const += u1 if fixed[r] == 1 else u0
        else:
            U0r[idx[r]] += u0
            U1r[idx[r]] += u1

    t_r, h_r = [], []
    E_r = [[], [], [], []]
    for e in range(len(tails)):
        a, b = tails[e], heads[e]
        ra, pa = root[a], par[a]
        rb, pb = root[b], par[b]
        # table over (x_ra, x_rb): t'(u, v) = t(u ^ pa, v ^ pb)
        t = np.array([[E[0][e], E[1][e]], [E[2][e], E[3][e]]])
        if pa:
            t = t[::-1]
        if pb:
            t = t[:, ::-1]
        fa = fixed[ra] if fixed[ra] >= 0 else None
        fb = fixed[rb] if fixed[rb] >= 0 else None
        if fa is not None and fb is not None:
            const += t[fa, fb]
        elif fa is not None:
            U0r[idx[rb]] += t[fa, 0]
            U1r[idx[rb]] += t[fa, 1]
        elif fb is not None:
            U0r[idx[ra]] += t[0, fb]
            U1r[idx[ra]] += t[1, fb]
        elif ra == rb:  # contracted onto one variable: diagonal
            U0r[idx[ra]] += t[0, 0]
            U1r[idx[ra]] += t[1, 1]
        else:
            t_r.append(idx[ra])
            h_r.append(idx[rb])
            for k, v in enumerate((t[0, 0], t[0, 1], t[1, 0], t[1, 1])):
                E_r[k].append(v)
    return (active, U0r, U1r, np.asarray(t_r, np.int32),
            np.asarray(h_r, np.int32),
            [np.asarray(x) for x in E_r], const)


def probe(U0, U1, tails, heads, E00, E01, E10, E11, weak: bool = True,
          max_rounds: int = 2):
    """QPBO-P (probing) — the native solver's ``Probe`` surface
    (cpp/QPBO-v1.3.src/QPBO_extra.cpp:708; Rother et al., "Optimizing Binary
    MRFs via Extended Roof Duality", CVPR 2007 §3.2).  Unused by the live
    pipeline (options.contract = 0, vgg_qpbo.m), provided for solver-API
    completeness on small problems — each probe is a fresh maxflow solve.

    For every still-unlabelled variable i, solve the energy with x_i pinned
    to 0 and to 1.  If a variable j is persistently labelled under both pins:
      * same label alpha under both  ->  fix x_j = alpha;
      * label equal to the pin value ->  contract x_j := x_i;
      * label opposite the pin value ->  contract x_j := NOT x_i.
    Each rule preserves at least one global minimizer; rules are applied
    *sequentially* (the energy is re-reduced after every change) so the
    guarantees compose.  Iterates to a fixpoint, at most ``max_rounds``
    passes.

    Returns (labels, rep, flip, n_fixed):
      labels [N] in {-1, 0, 1} — value for fixed variables, -1 otherwise;
      rep    [N] — representative variable id (the ``mapping`` analog):
                   x_i == x_rep[i] XOR flip[i] in some global optimum;
      flip   [N] in {0, 1};
      n_fixed — number of variables with labels >= 0.
    """
    U0 = np.ascontiguousarray(U0, np.float64).ravel()
    U1 = np.ascontiguousarray(U1, np.float64).ravel()
    tails = np.ascontiguousarray(tails, np.int64).ravel()
    heads = np.ascontiguousarray(heads, np.int64).ravel()
    E = [np.ascontiguousarray(x, np.float64).ravel()
         for x in (E00, E01, E10, E11)]
    n = len(U0)
    uf = _ParityUF(n)
    fixed = np.full(n, -1, np.int64)
    scale = max(float(np.abs(U0).max(initial=0.0)),
                float(np.abs(U1).max(initial=0.0)),
                max((float(np.abs(x).max()) for x in E if x.size),
                    default=0.0), 1.0)
    BIG = 1e7 * scale * max(n, 1)

    def fix_from_labels(roots, labels):
        changed = False
        for k, lab in enumerate(labels):
            if lab >= 0 and fixed[roots[k]] < 0:
                fixed[roots[k]] = int(lab)
                changed = True
        return changed

    for _ in range(max_rounds):
        roots, u0, u1, tr, hr, er, _ = _reduce_problem(
            U0, U1, tails, heads, E, uf, fixed)
        if not roots:
            break
        labels, _, _, _ = solve(u0, u1, tr, hr, *er, weak=weak)
        changed = fix_from_labels(roots, labels)

        for i_root in list(roots):
            if fixed[i_root] >= 0:
                continue
            r, p = uf.find(i_root)
            if r != i_root:  # merged away by an earlier probe this round
                continue
            roots, u0, u1, tr, hr, er, _ = _reduce_problem(
                U0, U1, tails, heads, E, uf, fixed)
            k_i = roots.index(i_root)
            probes = []
            for pin in (0, 1):
                u0p, u1p = u0.copy(), u1.copy()
                if pin == 0:
                    u1p[k_i] += BIG
                else:
                    u0p[k_i] += BIG
                lab, _, _, _ = solve(u0p, u1p, tr, hr, *er, weak=weak)
                probes.append(lab)
            L0, L1 = probes
            for k, r_j in enumerate(roots):
                if k == k_i or L0[k] < 0 or L1[k] < 0:
                    continue
                if L0[k] == L1[k]:
                    if fixed[r_j] < 0:
                        fixed[r_j] = int(L0[k])
                        changed = True
                else:  # L0 != L1: x_j tracks (or anti-tracks) x_i
                    rel = 0 if (L0[k] == 0 and L1[k] == 1) else 1
                    if uf.union(r_j, i_root, rel):
                        changed = True
        if not changed:
            break

    labels_out = np.full(n, -1, np.int64)
    rep = np.empty(n, np.int64)
    flip = np.empty(n, np.int64)
    for i in range(n):
        r, p = uf.find(i)
        rep[i] = r
        flip[i] = p
        if fixed[r] >= 0:
            labels_out[i] = fixed[r] ^ p
    return labels_out, rep, flip, int((labels_out >= 0).sum())


def labeling_energy(lab, U0, U1, tails, heads, E00, E01, E10, E11):
    """Energy of a full 0/1 labeling under the same inputs."""
    lab = np.asarray(lab)
    E = np.where(lab == 1, U1, U0).sum()
    xi = lab[tails] == 1
    xj = lab[heads] == 1
    E += np.where(xi, np.where(xj, E11, E10), np.where(xj, E01, E00)).sum()
    return float(E)
