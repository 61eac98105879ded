"""Build one kernel source alone, hold it against its plain version and time
it: the short loop for work on csrc/banded_kernel.cu (kernel 5, the
default), csrc/wavefront_kernel.cu (kernel 6), csrc/phase_kernel.cu
(kernels 1 and 2), csrc/minplus_send.cu (kernel 4) or csrc/minplus_pair.cu
(kernel 3).

    python3 tools/time_banded_kernel.py [--kernel banded|wavefront|phase|send|pair]
    python3 tools/time_banded_kernel.py --kernel phase|send|pair --against DIR ...
    python3 tools/time_banded_kernel.py --kernel phase --message-dtype bfloat16

Needs one NVIDIA GPU and nvcc.  It builds only the kernel's source, then
runs chip_smoke.py's own functions (no second copy of them).  For a fused
sweep: ``banded_sweep_vs_plain`` / ``wavefront_sweep_vs_plain`` (every
``BANDED_CASES`` / ``WAVEFRONT_CASES`` entry, both smoothness kernels, from
zero and from the warm state, bit for bit), the repeatability check
``banded_sweep_repeatable`` / ``wavefront_sweep_repeatable`` (two sweeps
from one state, same bits), and ``time_banded_sweep`` /
``time_wavefront_sweep`` at teddy's shape, K = 79, and at K = 15 on
370 x 413, the two shapes that split a step's fixed cost from its
arithmetic (median of 12 sweeps each); the wavefront kernel also at teddy's
K = 202 (median of 4).  For the phase, send and pair kernels: the
instruction mix of the largest basic blocks of each entry function
(``cuobjdump -sass``, where the toolkit has it; the K^2 loops are the
largest), every comparison of chip_smoke.py for the kernel, bit for bit
(``phase_vs_plain``, ``send_vs_plain`` with the gathered calls,
``pair_vs_plain``), and the kernel's times: ``time_phase`` at teddy's
K = 79 (compact 188 x 450, full grid 375 x 450) and at K = 15 (compact
185 x 413, full grid 370 x 413), median of 20 launches each; the send as
the one launch of a banded step (six problems, L = 1536) and of a
wavefront step (two, L = 375) at K = 79, on the host's clock (50 calls
back to back, then a synchronise) and on the device (torch.profiler); the
pair at [79, 375, 450] (median of 20).  The phase rows carry the times with
bfloat16 and float16 message storage too (``ms_bf16``, ``ms_f16``).
``--against`` names the csrc/ directories of other trees (a parent unpacked
beside this one, a variant): their source is built too (with the wrappers
of their own ops/minplus.py where the directory has one beside it),
checked against the plain versions
(phase: at 37 x 53, K = 15 and 79, both smoothness kernels; send: a banded
and a wavefront step at K = 79, a < 0 on a third of the lanes; pair:
37 x 53 at K = 17 and 79 and K = 202 on 19 x 53), and timed in the same
process, in turns with this tree's (phase: ``--message-dtype bfloat16``
times this tree's kernels with bfloat16 message storage and with float32
in turns with the other trees' float32 ones, and needs no ``--against``;
``ROUNDS`` rounds, the order reversed every other round; phase and pair: a
run of 50 launches back to back between two CUDA events; send: 50 step
calls on the host's clock, and the device time of 20 under the profiler,
of the send kernels and of every kernel of the call), so that the versions
share the card's state.  A tree
whose send has no gathered entry point (the parent's) makes a step's sends
as its solvers did: one call of its ``minplus_send`` per send, on
h = g - m formed by a subtraction.  These in-turn times are for comparing
versions; a kernel's own time is chip_smoke.py's ``kernels`` line.  The
rows carry the kernel's issue floor (``issue_floor_ms``: terms at
``INSTR_PER_TERM`` issued instructions over ``PEAK_INSTR``; a pair's six),
computed, not measured.  One JSON line per step, the build's with ptxas's
registers and spills per entry function; the card's name and power limit
last.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import importlib.util
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402  (exits at once without a GPU)
from stereo_tpu_torch.ops import _build, minplus, phase_kernel  # noqa: E402

# instructions that end a basic block; those of them with a target start one
ENDS_BLOCK = ("BRA", "BRX", "JMP", "JMX", "CALL", "RET", "EXIT", "BSSY",
              "BSYNC", "BREAK", "WARPSYNC")
FLOAT_OPS = ("FADD", "FMUL", "FMNMX", "FFMA")
# the phase kernels' issue floor: one float32 instruction per lane and cycle
# (132 SMs x 128 lanes at the 1.98 GHz boost clock), four issued a term once
# the truncation is hoisted out of the K^2 loop (sub, mul with |.|, add, min)
PEAK_INSTR = 132 * 128 * 1.98e9
INSTR_PER_TERM = 4
INSTR_PER_PAIR = 6  # the pair kernel: + add, min for its second output
# rounds of the in-turn timing (--against)
ROUNDS = 8


def opcode(text: str) -> str:
    """'@!P0 FMNMX.FTZ R1, ...' -> 'FMNMX'."""
    return re.sub(r"^@!?U?P\w+\s+", "", text).split()[0].split(".")[0]


def short_name(mangled: str) -> str:
    """'_ZN..20phase_compact_kernelILi1EEEv..' -> 'phase_compact_kernel<1>'."""
    m = re.search(r"([a-z]+(?:_[a-z]+)*_kernel)I((?:Li\d+E)+)E", mangled)
    if not m:
        return mangled
    return f"{m.group(1)}<{','.join(re.findall(r'Li(\d+)E', m.group(2)))}>"


def sass_mix(lib: str, top: int = 4) -> dict | None:
    """The ``top`` largest basic blocks of each entry function of a built
    library: instructions, their opcodes, and per min-plus term (a term has
    one multiply per power of the smoothness kernel, the first template
    argument) the issued instructions and the float32 ones.  None where the
    toolkit has no cuobjdump."""
    exe = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(_build._nvcc()), "cuobjdump")
    if not os.path.exists(exe):
        return None
    sass = subprocess.run([exe, "-sass", lib], capture_output=True, text=True,
                          check=True).stdout
    funcs, fn = {}, None
    for ln in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", ln)
        if m:
            fn = short_name(m.group(1))
            funcs[fn] = []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", ln)
        if m and fn:
            funcs[fn].append((int(m.group(1), 16), m.group(2)))
    out = {}
    for fn, ins in funcs.items():
        leaders = {int(t, 16) for _, text in ins
                   if opcode(text) in ENDS_BLOCK
                   for t in re.findall(r"0x([0-9a-f]+)", text)}
        blocks, cur = [], []
        for addr, text in ins:
            if addr in leaders and cur:
                blocks.append(cur)
                cur = []
            cur.append(opcode(text))
            if cur[-1] in ENDS_BLOCK:
                blocks.append(cur)
                cur = []
        blocks.append(cur)
        power = int(fn.split("<")[1][0]) if "<" in fn else 1
        rows = []
        for b in sorted(blocks, key=len, reverse=True)[:top]:
            mix = collections.Counter(b)
            terms = mix["FMUL"] // power
            rows.append(dict(
                instructions=len(b), terms=terms,
                issued_per_term=len(b) / terms if terms else None,
                float_per_term=(sum(mix[o] for o in FLOAT_OPS) / terms
                                if terms else None),
                mix=dict(mix.most_common())))
        out[fn] = rows
    return out


def build(name: str, csrc_dir: str) -> str:
    """csrc_dir/<name>.cu built with the package's flags (into the
    package's build directory, under the digest of that tree's sources):
    the library's path."""
    src, out, flags = _build._target(name, csrc_dir=csrc_dir)
    if not os.path.exists(out):
        os.makedirs(_build.BUILD_DIR, exist_ok=True)
        done = subprocess.run([_build._nvcc(), *flags, "-o", out, src],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if done.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{done.stdout}")
        cs.say("build", source=src, ptxas=cs.ptxas_by_function(done.stdout))
    return out


def tree_minplus(csrc_dir: str, name: str):
    """The min-plus wrappers of another tree, with its own ``name`` library
    (csrc_dir/<name>.cu) bound: the ops/minplus.py beside csrc_dir where
    there is one (the tree's own wrappers and C interface), else this
    tree's, loaded anew so that its libraries are its own."""
    path = os.path.join(os.path.dirname(os.path.abspath(csrc_dir)), "ops",
                        "minplus.py")
    if not os.path.exists(path):
        path = minplus.__file__
    spec = importlib.util.spec_from_file_location(
        f"minplus_{abs(hash(csrc_dir))}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod._libs[name] = mod._BINDERS[name](ctypes.CDLL(build(name, csrc_dir)))
    return mod


def batch_ms(fn, n: int = 50, warmup: int = 5) -> float:
    """ms per launch of ``n`` launches back to back, between two CUDA
    events: the card is not left idle between launches, as it is between
    the synchronised single launches of ``chip_smoke.time_ms``, so the
    versions timed in turns meet the same clocks."""
    for _ in range(warmup):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def issue_floor_ms(row: dict) -> float:
    """The issue floor of a ``time_phase`` row: K^2 terms for each of its
    sends (the compact kernel 8 over its Hc x W half-grid, the full-grid one
    4 over H x W)."""
    s = row["shape"]
    sends = (8 * s["Hc"] * s["W"] if row["name"] == "phase_messages_compact"
             else 4 * s["H"] * s["W"])
    return s["K"] ** 2 * sends * INSTR_PER_TERM / PEAK_INSTR * 1e3


def phase_in_turns(others: list[str], smi: str, m_dtype=torch.float32):
    """This tree's phase kernels with ``m_dtype`` message storage (and, for
    a narrow one, with float32 too) and those of ``others`` (csrc/
    directories, float32 storage), each checked against the plain versions,
    then timed in turns."""
    this = phase_kernel._library()
    runs = {f"this/{m_dtype}".replace("torch.", ""): (this, m_dtype)}
    if m_dtype != torch.float32:
        runs["this/float32"] = (this, torch.float32)
    for d in others:
        runs[os.path.abspath(d)] = (phase_kernel.bind(
            ctypes.CDLL(build("phase_kernel", d))), torch.float32)
    err = {"phase_messages_compact": 0.0, "phase_messages": 0.0}
    for name, (lib, dt) in runs.items():
        phase_kernel._lib = lib
        for K in (15, 79):
            for kernel in (1, 2):
                cs.phase_case(err, K, 37, 53, kernel,
                              1.1 if kernel == 1 else 0.9, K + kernel,
                              m_dtype=dt)
        cs.say("checked", tree=name, max_abs_err=err)
    times = collections.defaultdict(list)
    for suffix, K, H, W in (("", *cs.FULL), ("_k15", 15, 370, 413)):
        for kernel, args, names, *_ in cs.phase_problems(K, H, W):
            fn = getattr(phase_kernel, kernel)
            targs = {dt: cs.narrow(args, names, dt)
                     for dt in {dt for _, dt in runs.values()}}
            for r in range(ROUNDS):
                for name in (list(runs) if r % 2 == 0 else list(runs)[::-1]):
                    lib, dt = runs[name]
                    phase_kernel._lib = lib
                    times[(kernel + suffix, name)].append(
                        batch_ms(lambda: fn(*targs[dt], 8.0, 1)))
            del args, targs
    for (kernel, name), ms in sorted(times.items()):
        cs.say("in_turns", kernel=kernel, tree=name, card=smi,
               median_ms=sorted(ms)[len(ms) // 2], ms=ms)
    phase_kernel._lib = this


def host_ms(fn, n: int = 50) -> float:
    """ms per call of ``n`` calls back to back on the host's clock, the last
    followed by a synchronise: the host's cost of a call where it exceeds
    the device's."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def device_per_call(fn, reps: int, match: str) -> dict:
    """Device ms per call under torch.profiler: of the kernels whose name
    holds ``match`` (and their launches per call), and of every kernel the
    call launches; ``reps`` calls recorded after as many unrecorded ones
    (a trace's first launches can be missing from its records)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    for _ in range(3):  # a trace that misses launches is taken again
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        kernel = total = launches = 0
        for e in prof.key_averages():
            if (e.device_type != torch.autograd.DeviceType.CUDA
                    or e.key.startswith("ProfilerStep")):
                continue
            total += e.self_device_time_total
            if match in e.key:
                kernel += e.self_device_time_total
                launches += e.count
        if launches and launches % reps == 0:
            break
    return dict(device_ms=kernel / reps * 1e-3,
                launches_per_call=launches / reps,
                device_ms_all_kernels=total / reps * 1e-3)


def step_sender(mod):
    """A step's sends through a tree's wrappers: its one gathered call, or,
    in a tree without one, one ``minplus_send`` per problem on h = g - m
    (as that tree's solvers made them)."""
    if hasattr(mod, "minplus_send_many"):
        return mod.minplus_send_many
    return lambda problems, tol, kernel: [
        mod.minplus_send(g - m, xt, ys, a, tol, kernel)
        for g, m, xt, ys, a in problems]


def step_floor_ms(problems, K: int) -> float:
    """The issue floor of a step's sends: K^2 terms per lane and batch entry
    at INSTR_PER_TERM issued instructions."""
    terms = sum(math.prod(torch.broadcast_shapes(
        g.shape[:-2], m.shape[:-2], xt.shape[:-2], alpha.shape[:-1]))
        * xt.shape[-1] * K * K for g, m, xt, _, alpha in problems)
    return terms * INSTR_PER_TERM / PEAK_INSTR * 1e3


def send_steps(smi: str):
    """This tree's gathered send as a banded and a wavefront step makes it
    at teddy K = 79."""
    K = cs.FULL[0]
    for sched in ("banded", "wavefront"):
        problems = cs.step_problems(1, K, sched)

        def call():
            minplus.minplus_send_many(problems, 8.0, 1)

        cs.say("send_step_" + sched, card=smi, host_ms=host_ms(call),
               event_ms=cs.time_ms(call, 50, warmup=5),
               issue_floor_ms=step_floor_ms(problems, K),
               **device_per_call(call, 20, "minplus_send"),
               **cs.step_bounds(problems, K))
        del problems


def send_in_turns(others: list[str], smi: str):
    """This tree's step sends and those of ``others`` (csrc/ directories),
    each checked against the plain version, then timed in turns."""
    trees = {"this": minplus}
    for d in others:
        trees[os.path.abspath(d)] = tree_minplus(d, "minplus_send")
    K = cs.FULL[0]
    for name, mod in trees.items():
        send = step_sender(mod)
        for sched in ("banded", "wavefront"):
            for kernel in (1, 2):
                problems = cs.step_problems(7 + kernel, K, sched,
                                            negative=1 / 3)
                got = send(problems, 1.1, kernel)
                torch.cuda.synchronize()
                ref = minplus.minplus_send_many_ref(problems, 1.1, kernel)
                cs.check(all(torch.equal(a, b) for g, r in zip(got, ref)
                             for a, b in zip(g, r)),
                         f"{name}: step send != plain version ({sched}, "
                         f"kernel {kernel})")
        cs.say("checked", tree=name, kernel="send")
    times = collections.defaultdict(list)
    for sched in ("banded", "wavefront"):
        problems = cs.step_problems(1, K, sched)
        for r in range(ROUNDS):
            for name in (list(trees) if r % 2 == 0 else list(trees)[::-1]):
                send = step_sender(trees[name])

                def call():
                    send(problems, 8.0, 1)

                times[(sched, name, "host_ms")].append(host_ms(call))
                if r < ROUNDS // 2:
                    for what, v in device_per_call(call, 20,
                                                   "minplus_send").items():
                        times[(sched, name, what)].append(v)
        del problems
    for (sched, name, what), v in sorted(times.items()):
        cs.say("in_turns", kernel="send_step_" + sched, tree=name, what=what,
               card=smi, median=statistics.median(v), values=v)


def pair_in_turns(others: list[str], smi: str):
    """This tree's pair kernel and those of ``others``, each checked against
    the plain version, then timed in turns at [79, 375, 450]."""
    trees = {"this": minplus}
    for d in others:
        trees[os.path.abspath(d)] = tree_minplus(d, "minplus_pair")
    for name, mod in trees.items():
        for K, H, W, negative in ((17, 37, 53, True), (79, 37, 53, True),
                                  (79, 37, 53, False), (202, 19, 53, False)):
            for kernel in (1, 2):
                inp = list(cs.testing.pair_inputs(K + kernel, K, H, W))
                if negative:
                    inp[4] = -inp[4]
                args = [torch.as_tensor(a, device=cs.DEV) for a in inp]
                got = mod.minplus_pair(*args, 1.1, kernel)
                torch.cuda.synchronize()
                ref = minplus.minplus_pair_ref(*args, 1.1, kernel)
                cs.check(all(torch.equal(a, b) for a, b in zip(got, ref)),
                         f"{name}: pair != plain version (K={K}, "
                         f"kernel {kernel}, negative={negative})")
        cs.say("checked", tree=name, kernel="pair")
    args = [torch.as_tensor(a, device=cs.DEV)
            for a in cs.testing.pair_inputs(1, *cs.FULL)]
    times = collections.defaultdict(list)
    for r in range(ROUNDS):
        for name in (list(trees) if r % 2 == 0 else list(trees)[::-1]):
            mod = trees[name]
            times[name].append(batch_ms(
                lambda: mod.minplus_pair(*args, 8.0, 1)))
    for name, ms in sorted(times.items()):
        cs.say("in_turns", kernel="minplus_pair", tree=name, card=smi,
               median_ms=statistics.median(ms), ms=ms)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", default="banded",
                    choices=("banded", "wavefront", "phase", "send", "pair"))
    ap.add_argument("--against", nargs="*", default=[],
                    help="csrc/ directories of other trees (phase, send "
                         "and pair)")
    ap.add_argument("--message-dtype", default="float32",
                    choices=("float32", "bfloat16"),
                    help="phase: the message storage of this tree's "
                         "kernels in turns (the other trees' float32)")
    args = ap.parse_args()
    kind = args.kernel
    smi = cs.nvidia_smi()
    source = f"minplus_{kind}" if kind in ("send", "pair") else f"{kind}_kernel"
    t0 = time.perf_counter()
    _build.load(source)
    log = _build.build_log.get(source, {})
    cs.say("build", source=source, seconds=time.perf_counter() - t0,
           ptxas=cs.ptxas_by_function(log.get("ptxas", "")))
    if kind in ("phase", "send", "pair"):
        cs.say("sass", inner_blocks=sass_mix(_build._target(source)[1]))
    if kind == "send":
        err = {"minplus_send": 0.0}
        cs.say("send_vs_plain", cases=cs.send_vs_plain(err),
               max_abs_err=err)
        send_steps(smi)
        if args.against:
            send_in_turns(args.against, smi)
        print(smi, flush=True)
        return
    if kind == "pair":
        err = {"minplus_pair": 0.0}
        cs.say("pair_vs_plain", cases=cs.pair_vs_plain(err),
               max_abs_err=err)
        pair = [torch.as_tensor(a, device=cs.DEV)
                for a in cs.testing.pair_inputs(1, *cs.FULL)]
        K, H, W = cs.FULL
        cs.say("minplus_pair", card=smi,
               ms=cs.time_ms(lambda: minplus.minplus_pair(*pair, 8.0, 1), 20),
               issue_floor_ms=K * K * H * W * INSTR_PER_PAIR / PEAK_INSTR
               * 1e3, **cs.pair_bounds(K, H * W))
        del pair
        if args.against:
            pair_in_turns(args.against, smi)
        print(smi, flush=True)
        return
    if kind == "phase":
        err = {name: 0.0 for name in ("phase_messages_compact",
                                      "phase_messages")}
        cs.say("phase_vs_plain", cases=cs.phase_vs_plain(err),
               max_abs_err=err)
        for suffix, K, H, W in (("", *cs.FULL), ("_k15", 15, 370, 413)):
            for row in cs.time_phase(K, H, W, plain=False):
                floor = issue_floor_ms(row)
                cs.say(row.pop("name") + suffix, card=smi,
                       issue_floor_ms=floor, **row)
        m_dtype = getattr(torch, args.message_dtype)
        if args.against or m_dtype != torch.float32:
            phase_in_turns(args.against, smi, m_dtype)
        print(smi, flush=True)
        return
    name = f"sweep_{kind}"
    err = {name: 0.0}
    if kind == "banded":
        cases = cs.banded_sweep_vs_plain(err)
        cs.say("banded_vs_plain", cases=cases, max_abs_err=err[name])
        cs.banded_sweep_repeatable()
        timed = [("", 79, 375, 450, 12), ("_k15", 15, 370, 413, 12)]
        time_sweep = cs.time_banded_sweep
    else:
        cases = cs.wavefront_sweep_vs_plain(err)
        cs.say("wavefront_vs_plain", cases=cases, max_abs_err=err[name])
        cs.wavefront_sweep_repeatable()
        timed = [("", 79, 375, 450, 12), ("_k15", 15, 370, 413, 12),
                 ("_k202", cs.K_WIDE, 375, 450, 4)]
        time_sweep = cs.time_wavefront_sweep
    for suffix, K, H, W, reps in timed:
        cs.say(name + suffix, card=smi,
               **time_sweep(K, H, W, reps, plain=False))
    print(smi, flush=True)


if __name__ == "__main__":
    main()
