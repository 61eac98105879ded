"""The plain reference's pieces, at small sizes, against their
definitions written out longhand."""

import itertools
import struct
import zlib

import numpy as np
import pytest
import torch

from portbench.reference import fusion, ncc, png, trws
from portbench.reference import planes as geo

DT = torch.float64


def _png_bytes(img: np.ndarray, filters) -> bytes:
    """An 8-bit RGB PNG of ``img`` with scanline filter ``filters[row]``,
    filtered byte by byte as the PNG specification defines."""
    H, W, _ = img.shape
    raw = img.reshape(H, W * 3).astype(np.int64)
    out = bytearray()
    for r in range(H):
        f = filters[r]
        out.append(f)
        for i in range(W * 3):
            a = raw[r, i - 3] if i >= 3 else 0
            b = raw[r - 1, i] if r > 0 else 0
            c = raw[r - 1, i - 3] if (r > 0 and i >= 3) else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            paeth = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            pred = [0, a, b, (a + b) // 2, paeth][f]
            out.append((raw[r, i] - pred) & 0xFF)

    def chunk(t, body):
        return (struct.pack(">I", len(body)) + t + body
                + struct.pack(">I", zlib.crc32(t + body) & 0xFFFFFFFF))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(out)))
            + chunk(b"IEND", b""))


def test_png_every_filter(tmp_path):
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (10, 7, 3), dtype=np.uint8)
    path = tmp_path / "x.png"
    path.write_bytes(_png_bytes(img, [0, 1, 2, 3, 4, 4, 3, 2, 1, 0]))
    got = png.read_rgb(str(path))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, img.astype(np.float32))


def test_box_sum_is_a_window_sum():
    x = torch.rand(2, 7, 9, dtype=DT)
    got = ncc.box_sum(x, 2)
    pad = torch.nn.functional.pad(x, (2, 2, 2, 2))
    want = torch.zeros_like(x)
    for dy, dx in itertools.product(range(5), range(5)):
        want += pad[:, dy:dy + 7, dx:dx + 9]
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)


def _ncc_longhand(im0, im1, y, x, d):
    """NCC at (y, x) (0-based) of im0 against im1 shifted by d: 5 x 5 x 3
    window, zero padding, the shifted image zero left of column d."""
    H, W, _ = im0.shape
    a, b = [], []
    for dy, dx in itertools.product(range(-2, 3), range(-2, 3)):
        yy, xx = y + dy, x + dx
        for c in range(3):
            ok = 0 <= yy < H and 0 <= xx < W
            a.append(im0[yy, xx, c] if ok else 0.0)
            b.append(im1[yy, xx - d, c] if ok and xx - d >= 0 else 0.0)
    a, b = np.array(a), np.array(b)
    a, b = a - a.mean(), b - b.mean()
    den = np.sqrt((a * a).sum() * (b * b).sum())
    return (a * b).sum() / den if den > 0 else 0.0


def test_ncc_volume_longhand():
    rng = np.random.default_rng(2)
    im0 = rng.uniform(0, 255, (9, 12, 3))
    im1 = rng.uniform(0, 255, (9, 12, 3))
    vol = ncc.ncc_volume(torch.as_tensor(im0), torch.as_tensor(im1),
                           np.arange(0, 5)).numpy()
    for d in range(5):
        for y in range(9):
            for x in range(12):
                want = _ncc_longhand(im0, im1, y, x, d) if x >= d else 0.0
                assert abs(vol[d, y, x] - want) < 1e-10, (d, y, x)


def test_wta_vertex_of_a_parabola():
    disp = np.arange(0, 6, dtype=np.float64)
    peak = torch.tensor([[2.3, 0.0, 5.0]], dtype=DT)  # inner, low end, high
    vol = -(torch.as_tensor(disp)[:, None, None] - peak) ** 2
    got = ncc.wta_disparity(vol, disp)
    torch.testing.assert_close(got, torch.tensor([[2.3, 0.0, 5.0]], dtype=DT))


def test_sample_ncc():
    disp = np.arange(0, 5, dtype=np.float64)
    vol = torch.rand(5, 2, 3, dtype=DT)
    for k in range(5):
        at = torch.full((2, 3), float(k), dtype=DT)
        torch.testing.assert_close(ncc.sample_ncc(vol, disp, at), vol[k])
    # 1.5 ties to level 2: the parabola through levels 1, 2, 3
    x = torch.full((2, 3), 1.5, dtype=DT)
    y1, y2, y3 = vol[1], vol[2], vol[3]
    want = (y1 * (1.5 - 2) * (1.5 - 3) / 2 - y2 * (1.5 - 1) * (1.5 - 3)
            + y3 * (1.5 - 1) * (1.5 - 2) / 2)
    torch.testing.assert_close(ncc.sample_ncc(vol, disp, x), want)
    # the end levels are read raw, outside the range -1e6
    torch.testing.assert_close(
        ncc.sample_ncc(vol, disp, torch.full((2, 3), 0.4, dtype=DT)),
        vol[0])
    out = ncc.sample_ncc(vol, disp, torch.full((2, 3), 4.5, dtype=DT))
    assert torch.all(out == -1e6)


def test_fit_plane_recovers_a_plane():
    rng = np.random.default_rng(3)
    xs, ys = rng.uniform(0, 20, 40), rng.uniform(0, 20, 40)
    ds = 0.3 * xs - 0.1 * ys + 7.0
    p = ncc.fit_plane(xs, ys, ds)
    # d = -(a x + b y + d0) / c with c = 1
    np.testing.assert_allclose(p, [-0.3, 0.1, 1.0, -7.0], atol=1e-9)


def test_proposals_order_and_ladder():
    ys, xs = np.mgrid[0:30, 0:40]
    wta = 4.0 + 0.1 * xs + np.random.default_rng(5).uniform(0, 0.5, (30, 40))
    planes, nodes = ncc.proposals(wta, 10, 20, 3.0, 10, origin=5)
    assert nodes[:4] == [(5, 5), (5, 15), (5, 25), (15, 5)]
    assert nodes[-3:] == [None] * 3
    np.testing.assert_allclose(planes[-1], [0, 0, 1, -20])


# per-edge weights and normalised disparities, as the global model has them
WEIGHTED = dict(normalize=(1.0, 6.0), seed=9)


def _weights(H, W, seed):
    """Per-edge weights in [1, 10], 0 where the tail lies outside."""
    g = torch.Generator().manual_seed(seed)
    return (1 + 9 * torch.rand(4, H, W, generator=g, dtype=DT)) * (
        geo.edge_mask(H, W, torch.zeros((), dtype=DT)))


def _energy_longhand(vol, disp, w, tol, planes, weights=None,
                     normalize=(0.0, 1.0)):
    H, W = planes.shape[-2:]
    own = geo.own_disparity(planes)
    e = float(ncc.unary(vol, disp, w, planes).sum())
    d_min, d_step = normalize
    for y in range(H):
        for x in range(W):
            for k, (dy, dx) in enumerate(geo.DIRS):
                n = (y + dy, x + dx)
                if 0 <= n[0] < H and 0 <= n[1] < W:
                    a, b, c, d = planes[:, n[0], n[1]].tolist()
                    dn = -(a * (x + 1) + b * (y + 1) + d) / c
                    gap = abs((float(own[y, x]) - d_min) / d_step
                              - (dn - d_min) / d_step)
                    e += (1.0 if weights is None else float(
                        weights[k, y, x])) * min(gap, tol)
    return e


@pytest.mark.parametrize("weighted", [False, True])
def test_energy_longhand(weighted):
    rng = np.random.default_rng(4)
    disp = np.arange(0, 8, dtype=np.float64)
    vol = torch.rand(8, 5, 6, dtype=DT)
    planes = torch.stack([
        torch.as_tensor(rng.uniform(-0.2, 0.2, (5, 6))),
        torch.as_tensor(rng.uniform(-0.2, 0.2, (5, 6))),
        torch.ones(5, 6, dtype=DT),
        torch.as_tensor(-rng.uniform(1, 6, (5, 6)))])
    if not weighted:
        got = ncc.energy(vol, disp, 40.0, 2.0, planes)
        want = _energy_longhand(vol, disp, 40.0, 2.0, planes)
    else:
        w, norm = _weights(5, 6, WEIGHTED["seed"]), WEIGHTED["normalize"]
        got = float(ncc.unary(vol, disp, 40.0, planes).sum()
                    + geo.smoothness(planes, 0.3, w, norm))
        want = _energy_longhand(vol, disp, 40.0, 0.3, planes, w, norm)
    assert got == pytest.approx(want, rel=1e-12)


def _move(vol, disp, tol, cur, prop, weighted):
    """(the NCC move of weight 40, its energy of a plane field)."""
    H, W = cur.shape[-2:]
    w, norm = ((_weights(H, W, WEIGHTED["seed"]), WEIGHTED["normalize"])
               if weighted else (geo.edge_mask(H, W, vol), None))

    def unary(p):
        return ncc.unary(vol, disp, 40.0, p)

    def energy(p):
        return float(unary(p).sum() + geo.smoothness(p, tol, w, norm))
    return fusion.Move(unary, w, tol, cur, prop, norm), energy


def _tiny_move(seed):
    rng = np.random.default_rng(seed)
    disp = np.arange(0, 6, dtype=np.float64)
    vol = torch.as_tensor(rng.uniform(-1, 1, (6, 3, 4)))
    cur = geo.fronto(torch.as_tensor(rng.uniform(0, 5, (3, 4))))
    prop = geo.fronto(torch.full((3, 4), float(rng.uniform(0, 5)),
                                   dtype=DT))
    return vol, disp, cur, prop


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("seed", range(3))
def test_move_never_raises_and_reports_its_energy(seed, weighted):
    vol, disp, cur, prop = _tiny_move(seed)
    move, energy = _move(vol, disp, 1.0 if not weighted else 0.2, cur, prop,
                         weighted)
    take, e = move.solve()
    fused = torch.where(take[None], prop, cur)
    assert e == pytest.approx(energy(fused), rel=1e-12)
    assert e <= energy(cur) + 1e-9
    # no labelling of this 12-pixel move is much better than the move's
    best = min(energy(torch.where(
        torch.as_tensor(np.array(z, bool).reshape(3, 4))[None], prop, cur))
        for z in itertools.product((0, 1), repeat=12))
    assert e >= best - 1e-9


def test_move_takes_a_proposal_better_everywhere():
    disp = np.arange(0, 6, dtype=np.float64)
    vol = torch.zeros(6, 4, 5, dtype=DT)
    vol[3] = 1.0  # NCC 1 at disparity 3, 0 elsewhere
    cur = geo.fronto(torch.full((4, 5), 1.0, dtype=DT))
    prop = geo.fronto(torch.full((4, 5), 3.0, dtype=DT))
    take, e = _move(vol, disp, 8.0, cur, prop, False)[0].solve()
    assert bool(take.all()) and e == pytest.approx(0.0)


def _grid_problem(seed, K, H, W, weighted=False):
    """Random K-label grid problem: theta, D0, Q, alphas (0 where the
    neighbour is missing), float64.  ``weighted``: alphas in [1, 10] and
    D0, Q normalised by WEIGHTED's (d_min, d_step)."""
    g = torch.Generator().manual_seed(seed)
    theta = torch.rand(K, H, W, generator=g, dtype=torch.float64) * 5
    D0 = (torch.rand(K, H, W, generator=g, dtype=torch.float64) - 0.5) * 6
    Q = (torch.rand(4, K, H, W, generator=g, dtype=torch.float64) - 0.5) * 6
    alphas = torch.rand(4, H, W, generator=g, dtype=torch.float64) + 0.5
    alphas[0, :, 0] = alphas[1, :, -1] = alphas[2, 0] = alphas[3, -1] = 0
    if weighted:
        alphas = _weights(H, W, seed)
        D0, Q = (geo.normalized(x, WEIGHTED["normalize"]) for x in (D0, Q))
    return theta, D0, Q, alphas


def _energies(theta, D0, Q, alphas, tol, labels):
    """Energy of each labelling labels [n, H, W]."""
    n = labels.shape[0]
    K, H, W = theta.shape
    E = torch.gather(theta.expand(n, K, H, W), 1, labels[:, None])[:, 0]
    E = E.sum((1, 2))
    own = torch.gather(D0.expand(n, K, H, W), 1, labels[:, None])[:, 0]
    for d, (dy, dx) in enumerate(geo.DIRS):
        nb = torch.roll(labels, shifts=(-dy, -dx), dims=(1, 2))
        q = torch.gather(Q[d].expand(n, K, H, W), 1, nb[:, None])[:, 0]
        E = E + (alphas[d] * (q - own).abs().clamp(max=tol)).sum((1, 2))
    return E


ORDERS = {"banded 2x2": lambda H, W: trws.banded_order(H, W, 2, 2),
          "raster": lambda H, W: trws.banded_order(H, W, H, W),
          "checkerboard": lambda H, W: trws.banded_order(H, W, H, W) % 2}


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("order", sorted(ORDERS))
def test_sweep_bound_is_below_every_labelling(order, weighted):
    K, H, W = 3, 3, 4
    # the same truncation in pixels, normalised where the problem is
    tol = 1.0 / (WEIGHTED["normalize"][1] if weighted else 1.0)
    theta, D0, Q, alphas = _grid_problem(5, K, H, W, weighted)
    labels = torch.tensor(list(itertools.product(range(K), repeat=H * W)))
    best = float(_energies(theta, D0, Q, alphas, tol,
                           labels.reshape(-1, H, W)).min())
    p = trws.Problem(theta, D0, Q, alphas, tol, ORDERS[order](H, W))
    g = torch.Generator().manual_seed(1)
    bounds = []
    for scale in (0.0, 3.0, 30.0):
        M = p.state((torch.rand(4, K, H, W, generator=g,
                                dtype=torch.float64) - 0.5) * scale)
        for _ in range(8):
            M, lb = p.sweep(M)
            bounds.append(float(lb))
    assert max(bounds) <= best + 1e-9
    assert max(bounds) > best - 0.1 * abs(best)  # and not a trivial one


@pytest.mark.parametrize("blocks", [(4, 4), (5, 3), None])
def test_sweep_is_the_programs_banded_sweep(blocks):
    """From a state of the program's banded TRW-S, one reference sweep
    gives the program's next sweep: bound and messages, float64."""
    from stereo_tpu_torch.solvers import banded, wavefront

    K, H, W, tol = 5, 12, 14, 1.0
    theta, D0, Q, alphas = _grid_problem(3, K, H, W)
    if blocks is None:
        run = lambda m, n: wavefront.solve_wavefront(  # noqa: E731
            theta, D0, Q, alphas, kernel=1, tol=tol, maxiter=n,
            max_relgap=0.0, use_kernel=False, messages=m)
        t = trws.banded_order(H, W, H, W)
    else:
        run = lambda m, n: banded.solve_banded(  # noqa: E731
            theta, D0, Q, alphas, kernel=1, tol=tol, Bh=blocks[0],
            Bw=blocks[1], maxiter=n, max_relgap=0.0, use_kernel=False,
            messages=m)
        t = trws.banded_order(H, W, *blocks)
    before = run(None, 12)
    after = run(before.messages, 1)
    p = trws.Problem(theta, D0, Q, alphas, tol, t)
    M, lb = p.sweep(p.state(before.messages))
    assert abs(float(lb) - float(after.lower_bound)) <= 1e-9
    assert torch.allclose(p.messages(M), after.messages, rtol=0, atol=1e-12)
    assert trws.certified_bound(theta, D0, Q, alphas, tol, t,
                                before.messages) == float(lb)
