"""Build one kernel source alone, hold it against its plain version and time
it: the short loop for work on csrc/banded_kernel.cu (kernel 5, the
default), csrc/wavefront_kernel.cu (kernel 6) or csrc/phase_kernel.cu
(kernels 1 and 2).

    python3 tools/time_banded_kernel.py [--kernel banded|wavefront|phase]
    python3 tools/time_banded_kernel.py --kernel phase --against DIR ...

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
K = 202 (median of 4).  For the phase kernels: the instruction mix of the
largest basic blocks of each entry function (``cuobjdump -sass``, where the
toolkit has it; the K^2 loops are the largest), ``phase_vs_plain`` (every
phase comparison of chip_smoke.py, bit for bit), and ``time_phase`` at
teddy's K = 79 (compact 188 x 450, full grid 375 x 450) and at K = 15
(compact 185 x 413, full grid 370 x 413), median of 20 launches each.
``--against`` names the csrc/ directories of other trees (a parent
unpacked beside this one, a variant): their phase_kernel.cu is built too,
checked against the plain versions at 37 x 53 (K = 15 and 79, both
smoothness kernels) and timed in the same process, in turns with this
tree's (``ROUNDS`` rounds, the order reversed every other round; each a
run of 50 launches back to back between two CUDA events), so that the
versions share the card's state.  These in-turn times are for comparing
versions; a kernel's own time is ``time_phase``'s, as chip_smoke.py's
``kernels`` line gives it.  The phase rows carry the kernels' issue floor
(``issue_floor_ms``: K^2 terms a send at ``INSTR_PER_TERM`` issued
instructions over ``PEAK_INSTR``), computed, not measured.  One JSON line
per step, the build's with ptxas's registers and spills per entry
function; the card's name and power limit last.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import os
import re
import shutil
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402  (exits at once without a GPU)
from stereo_tpu_torch.ops import _build, phase_kernel  # noqa: E402

# instructions that end a basic block; those of them with a target start one
ENDS_BLOCK = ("BRA", "BRX", "JMP", "JMX", "CALL", "RET", "EXIT", "BSSY",
              "BSYNC", "BREAK", "WARPSYNC")
FLOAT_OPS = ("FADD", "FMUL", "FMNMX", "FFMA")
# the phase kernels' issue floor: one float32 instruction per lane and cycle
# (132 SMs x 128 lanes at the 1.98 GHz boost clock), four issued a term once
# the truncation is hoisted out of the K^2 loop (sub, mul with |.|, add, min)
PEAK_INSTR = 132 * 128 * 1.98e9
INSTR_PER_TERM = 4
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


def build_phase(csrc_dir: str) -> ctypes.CDLL:
    """csrc_dir/phase_kernel.cu built with the package's flags (into the
    package's build directory, under the digest of that tree's sources) and
    bound."""
    src, out, flags = _build._target("phase_kernel", csrc_dir=csrc_dir)
    if not os.path.exists(out):
        os.makedirs(_build.BUILD_DIR, exist_ok=True)
        done = subprocess.run([_build._nvcc(), *flags, "-o", out, src],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if done.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{done.stdout}")
        cs.say("build", source=src, ptxas=cs.ptxas_by_function(done.stdout))
    return phase_kernel.bind(ctypes.CDLL(out))


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


def phase_in_turns(others: list[str], smi: str):
    """This tree's phase kernels and those of ``others`` (csrc/ directories),
    each checked against the plain versions, then timed in turns."""
    libs = {"this": phase_kernel._library()}
    for d in others:
        libs[os.path.abspath(d)] = build_phase(d)
    err = {"phase_messages_compact": 0.0, "phase_messages": 0.0}
    for name, lib in libs.items():
        phase_kernel._lib = lib
        for K in (15, 79):
            for kernel in (1, 2):
                cs.phase_case(err, K, 37, 53, kernel,
                              1.1 if kernel == 1 else 0.9, K + kernel)
        cs.say("checked", tree=name, max_abs_err=err)
    times = collections.defaultdict(list)
    for suffix, K, H, W in (("", *cs.FULL), ("_k15", 15, 370, 413)):
        for kernel, args, *_ in cs.phase_problems(K, H, W):
            fn = getattr(phase_kernel, kernel)
            for r in range(ROUNDS):
                for name in (list(libs) if r % 2 == 0 else list(libs)[::-1]):
                    phase_kernel._lib = libs[name]
                    times[(kernel + suffix, name)].append(
                        batch_ms(lambda: fn(*args, 8.0, 1)))
            del args
    for (kernel, name), ms in sorted(times.items()):
        cs.say("in_turns", kernel=kernel, tree=name, card=smi,
               median_ms=sorted(ms)[len(ms) // 2], ms=ms)
    phase_kernel._lib = libs["this"]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=("banded", "wavefront", "phase"),
                    default="banded")
    ap.add_argument("--against", nargs="*", default=[],
                    help="csrc/ directories of other trees (phase only)")
    args = ap.parse_args()
    kind = args.kernel
    smi = cs.nvidia_smi()
    source = f"{kind}_kernel"
    t0 = time.perf_counter()
    _build.load(source)
    log = _build.build_log.get(source, {})
    cs.say("build", source=source, seconds=time.perf_counter() - t0,
           ptxas=cs.ptxas_by_function(log.get("ptxas", "")))
    if kind == "phase":
        cs.say("sass", inner_blocks=sass_mix(_build._target(source)[1]))
        err = {name: 0.0 for name in ("phase_messages_compact",
                                      "phase_messages")}
        cs.say("phase_vs_plain", cases=cs.phase_vs_plain(err),
               max_abs_err=err)
        for suffix, K, H, W in (("", *cs.FULL), ("_k15", 15, 370, 413)):
            for row in cs.time_phase(K, H, W, plain=False):
                floor = issue_floor_ms(row)
                cs.say(row.pop("name") + suffix, card=smi,
                       issue_floor_ms=floor, **row)
        if args.against:
            phase_in_turns(args.against, smi)
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
