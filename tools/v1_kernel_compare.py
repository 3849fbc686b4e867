#!/usr/bin/env python3
"""Apportion and compare the port's v1 structured-matvec kernel (a thread
a node column marching x, Ke in the constant bank) on one NVIDIA card.

Run from the repository root, on a machine with the card and nvcc:

    mkdir -p build/parent && git archive 1aab56a \\
        pcg_mpi_solver_tpu_torch/csrc | tar -x -C build/parent
    python3 tools/v1_kernel_compare.py \\
        --parent build/parent/pcg_mpi_solver_tpu_torch/csrc \\
        --apportion --levers --flagship

(1aab56a holds the old v1: fixed 16-plane segments, one thread a column
and segment, a grid of ceil(columns x segments / 128) blocks, the C
interface (P, nx, ny, nz, device).)

Prints:
  * --apportion: the old v1 (from --parent) at 150^3 and at two shapes
    whose grids are whole waves of the card's resident blocks, every block
    with the same planes (nx + 1 = 160, (ny + 1)(nz + 1) = 256 x SMs or
    512 x SMs), the latter also with 32-plane segments (a patched copy of
    the source); times in turns, L2 flushed, median of 25; its registers
    and resident blocks an SM; the time of one march step of a block
    slot; the list-scheduled makespan of its 150^3 grid in steps; and the
    split of its 150^3 time into march, recompute and the rest (wave
    tail); the SASS mix of its march loop by opcode class;
  * --levers: the shipped v1, the old v1 and patched copies of the shipped
    source (LEVERS: each without one lever or with another choice in its
    place), and the shipped v1 on other grids (ten blocks a column tile,
    two and one blocks an SM), in turns at 150^3; each build's bits
    against the old v1 at the card tests', chip_smoke.py's v1 edge and
    the flagship shapes; registers, resident blocks and the SASS mix of
    each build's march loop (the old and the shipped loops' SASS written
    to chiprun_out/); the SM clock and power nvidia-smi reads while the
    old and the shipped v1 run back to back;
  * --parent-bits: kernel_builds.parent over every variant (v1 through
    the old v1's C interface): bits at every chip_smoke.py shape, v1's
    time in turns;
  * --probe: tools/smem_probe.cu's SM cycles a warp FFMA with Ke from
    registers and as the constant-bank operand (each Ke value feeding two
    cells' FFMAs, as v1's two nodes do) at 16 warps an SM: the product's
    instruction stream alone, without v1's loads, stores and moves;
  * --flagship: the 150^3 mixed solve under v1, then v6.
Builds go to build/v1_compare/.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import heapq
import shutil
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

from kernel_builds import (  # noqa: E402
    CSRC, blocks_by_registers, build, flagship, inner_loop, load,
    nvidia_smi, opcode_classes, parent, resource_usage, sass_functions,
    smem_probe, time_ms)

OUT = ROOT / "build" / "v1_compare"
N = 150
PREFIX = "structured_matvec_v1"
OLD_THREADS = 128           # the old v1's kThreads
OLD_SEGMENT = 16            # the old v1's kSegment
CLASS_KEYS = ("FFMA", "FFMA c[]", "float", "integer", "LDG", "STG", "MOV",
              "ULDC", "LDC", "branch", "other")


def mix(code) -> str:
    c = opcode_classes(code)
    total = sum(v for k, v in c.items() if k != "FFMA c[]")
    per = f"{total / c['FFMA']:.3f}" if c["FFMA"] else "n/a"
    return (f"{total} instructions, {per} a FFMA; "
            f"{ {k: c[k] for k in CLASS_KEYS if c[k]} }")


def patched(src_dir: Path, name: str, edits) -> Path:
    """A copy of ``src_dir`` under OUT/name whose v1 source has each (old,
    new) of ``edits`` applied (each old text must occur exactly once)."""
    dst = OUT / name
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src_dir, dst)
    path = dst / f"{PREFIX}.cu"
    text = path.read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: {old!r} occurs {text.count(old)} "
                               f"times in {path}")
        text = text.replace(old, new)
    path.write_text(text)
    return path


def old_block_steps(shape, segment: int) -> list:
    """March steps (cell planes, the recomputed one included) of each block
    of the old v1's grid, in block order: thread (p, seg, iy, iz) steps x0 - 1
    .. x1 - 1 of its segment; a block lasts as long as its longest
    thread."""
    P, nx, ny, nz = shape
    nxn, cols = nx + 1, (ny + 1) * (nz + 1)
    n_seg = -(-nxn // segment)
    steps = [min(s * segment + segment, nxn) - s * segment + 1
             for s in range(n_seg)]
    total = P * n_seg * cols
    out = []
    for b in range(-(-total // OLD_THREADS)):
        t0, t1 = b * OLD_THREADS, min(total, (b + 1) * OLD_THREADS) - 1
        segs = {(t // cols) % n_seg for t in (t0, t1)}
        segs |= set(range(min(segs), max(segs) + 1))
        out.append(max(steps[s] for s in segs))
    return out


def makespan(durations, slots: int) -> float:
    """Blocks started in order on the first free of ``slots`` slots, each
    running for its duration: when the last one ends."""
    free = [0.0] * slots
    for d in durations:
        t = heapq.heappop(free)
        heapq.heappush(free, t + d)
    return max(free)


def data(torch, np, rng, shape):
    P, nx, ny, nz = shape
    x = torch.as_tensor(rng.standard_normal((P, 3, nx + 1, ny + 1, nz + 1)),
                        dtype=torch.float32, device="cuda")
    ck = torch.as_tensor(rng.uniform(1, 10, (P, nx, ny, nz)),
                         dtype=torch.float32, device="cuda")
    return x, ck


def runner(torch, h, args, x, ck, shape, sms):
    """A launch of ``h``'s v1 entry point on (x, ck) into its own y, with
    the launch arguments ``args(variant, *shape, dtype, planes, sms)``."""
    P, nx, ny, nz = shape
    extra = args("v1", *shape, torch.float32, None, sms)
    fn = getattr(h, f"{PREFIX}_f32")
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        err = fn(x.data_ptr(), ck.data_ptr(), y.data_ptr(), P, nx, ny, nz,
                 *extra, 0, stream)
        if err:
            raise RuntimeError(f"v1 launch failed: {err}")
        return y
    return run


def in_turns(torch, runs: dict) -> dict:
    """{tag: [ms, ms]}: each run timed in order, then in the reverse
    order."""
    t = collections.defaultdict(list)
    for tag in list(runs) + list(runs)[::-1]:
        t[tag].append(round(time_ms(torch, runs[tag]), 4))
    return dict(t)


def clocks_under_load(torch, run, seconds: float = 2.0) -> list:
    """SM clock (MHz) and power (W) that nvidia-smi reads while ``run`` is
    launched back to back for ``seconds``."""
    samples, stop = [], threading.Event()

    def sample():
        while not stop.is_set():
            out = subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                 "--format=csv,noheader,nounits"], capture_output=True,
                text=True).stdout.strip().splitlines()
            if out:
                samples.append(tuple(float(v) for v in out[0].split(",")))

    thread = threading.Thread(target=sample)
    thread.start()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(200):
            run()
        torch.cuda.synchronize()
    stop.set()
    thread.join()
    return samples


def registers(path: Path) -> int:
    (usage,) = resource_usage(path).values()
    return usage["REG"]


def apportion(torch, np, parent_csrc: Path, K, sms: int) -> None:
    """the old v1 at 150^3 against whole-wave shapes: the split of its time
    into march, recompute and the rest."""
    from kernel_builds import source_launch_args

    src = parent_csrc / f"{PREFIX}.cu"
    seg32 = patched(parent_csrc, "old_seg32",
                    [("constexpr int kSegment = 16;",
                      "constexpr int kSegment = 32;")])
    paths = {16: build(src, OUT, "old_v1"), 32: build(seg32, OUT,
                                                      "old_v1_seg32")}
    args = source_launch_args(torch, src, "v1")
    libs = {s: load(p, PREFIX, ("f32",), 5) for s, p in paths.items()}
    stream = torch.cuda.current_stream().cuda_stream
    for h in libs.values():
        getattr(h, f"{PREFIX}_stage_f32")(K.data_ptr(), 0, stream)
    regs = registers(paths[16])
    per_sm = blocks_by_registers(regs, OLD_THREADS)
    slots = sms * per_sm
    print(f"apportion: the old v1 {regs} registers (32-plane build "
          f"{registers(paths[32])}), {per_sm} blocks of {OLD_THREADS} an "
          f"SM by registers, {slots} block slots on {sms} SMs")
    # whole waves: 160 node planes (10 segments of 16, 5 of 32) and
    # 256 x sms or 512 x sms columns (2 or 4 x sms tiles of 128)
    shapes = {"150^3 seg 16": ((1, N, N, N), 16),
              "A seg 16": ((1, 159, sms - 1, 255), 16),
              "B seg 16": ((1, 159, 2 * sms - 1, 255), 16),
              "B seg 32": ((1, 159, 2 * sms - 1, 255), 32)}
    rng = np.random.default_rng(0)
    runs, steps = {}, {}
    for tag, (shape, seg) in shapes.items():
        x, ck = data(torch, np, rng, shape)
        runs[tag] = runner(torch, libs[seg], args, x, ck, shape, sms)
        steps[tag] = old_block_steps(shape, seg)
        d = steps[tag]
        print(f"apportion: {tag} {shape}: {len(d)} blocks "
              f"({len(d) / slots:.3f} waves), steps a block "
              f"{dict(collections.Counter(d))}, list-scheduled makespan "
              f"{makespan(d, slots):.2f} steps")
    t = in_turns(torch, runs)
    print(f"apportion: ms in turns, L2 flushed: {t}")
    med = {k: sum(v) / len(v) for k, v in t.items()}
    tau = {k: med[k] / makespan(steps[k], slots) for k in shapes}
    print(f"apportion: ms a step of a block slot (time / makespan): "
          f"{ {k: round(v, 6) for k, v in tau.items()} }")
    # the march rate, from shape A's whole waves of 17-step blocks
    step = tau["A seg 16"]
    cols = (N + 1) ** 2
    tiles_planes = cols * (N + 1) / OLD_THREADS / slots   # steps of march
    recompute = cols * ((N + 1 + 15) // 16 - 1) / OLD_THREADS / slots
    model = makespan(steps["150^3 seg 16"], slots)
    t150 = med["150^3 seg 16"]
    print(f"apportion: 150^3 at A's step {step:.6f} ms: march "
          f"{tiles_planes:.2f} steps = {tiles_planes * step:.4f} ms, "
          f"recompute {recompute:.2f} steps = {recompute * step:.4f} ms, "
          f"model makespan {model:.2f} steps = {model * step:.4f} ms; "
          f"measured {t150:.4f} ms = {t150 / step:.2f} steps; rest (wave "
          f"tail, partial blocks) "
          f"{t150 - (tiles_planes + recompute) * step:.4f} ms")
    b16, b32 = med["B seg 16"], med["B seg 32"]
    print(f"apportion: recompute at B, whole waves: 16-plane segments "
          f"{b16:.4f} ms against 32-plane {b32:.4f} ms: {b16 / b32:.4f} "
          f"(a full step a segment predicts {(17 / 16) / (33 / 32):.4f})")
    for name, code in sass_functions(paths[16]).items():
        body = inner_loop(code) or code
        print(f"sass the old v1 march loop: {mix(body)}")
        print(f"sass the old v1 whole kernel: {mix(code)}")


# The lever builds: patched copies of the shipped source, each without
# one of its levers or with another choice in its place: tag -> edits.
PREFETCH = """    if (i + 2 <= end) prefetch_plane(col, i + 2, plane, grid);
"""
MOVES = PREFETCH + """\
    step(b, a, col, i, i + 1 < e, carry, plane, cplane, grid);
    if (i + 1 < end) {
#pragma unroll
      for (int c = 0; c < 3; ++c)
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
          for (int kz = 0; kz < kWz; ++kz) b[c][dy][kz] = a[c][dy][kz];
      load_plane(a, col, i + 2, plane, grid);
    }
  }
"""
# the march unrolled by two planes, the windows swapping roles
PING_PONG = """    step(b, a, col, i, true, carry, plane, cplane, grid);
    load_plane(b, col, i + 2, plane, grid);
    if (i + 3 <= end) prefetch_plane(col, i + 3, plane, grid);
    step(a, b, col, i + 1, i + 2 < e, carry, plane, cplane, grid);
    if (i + 3 <= end) load_plane(a, col, i + 3, plane, grid);
  }
  if (i < end) step(b, a, col, i, i + 1 < e, carry, plane, cplane, grid);
"""
PREFETCH_CK = PREFETCH + """    if (i + 1 < end) {
      const float* cp = opaque(col.ck + (i + 1) * cplane);
#pragma unroll
      for (int ey = 0; ey < 2; ++ey)
        asm volatile("prefetch.global.L1 [%0];" ::"l"(cp + col.crow[ey]));
    }
"""
PREFETCH_L2 = PREFETCH + """    if (i + 3 <= end) {
      const float* xp = opaque(col.x + (i + 3) * plane);
#pragma unroll
      for (int c = 0; c < 3; ++c)
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
          asm volatile("prefetch.global.L2 [%0];"
                       ::"l"(xp + (c * grid + col.row[dy])));
    }
"""


def nodes(n: int, blocks: int) -> list:
    return [("constexpr int kNodes = 2;", f"constexpr int kNodes = {n};"),
            ("constexpr int kMinBlocks = 3;",
             f"constexpr int kMinBlocks = {blocks};")]


LEVERS = {
    "one node": nodes(1, 4),
    "three nodes": nodes(3, 2),
    "2 blocks": [("constexpr int kMinBlocks = 3;",
                  "constexpr int kMinBlocks = 2;")],
    "no prefetch": [(PREFETCH, "")],
    "prefetch 3 ahead": [(PREFETCH, PREFETCH.replace("2", "3"))],
    "prefetch ck": [(PREFETCH, PREFETCH_CK)],
    "prefetch L2": [(PREFETCH, PREFETCH_L2)],
    "ping-pong": [("  for (int i = s; i < end; ++i) {\n" + MOVES,
                   "  int i = s;\n  for (; i + 1 < end; i += 2) {\n"
                   + PREFETCH + PING_PONG)],
    "no opaque": [('  asm("" : "+l"(p));\n', "")],
}
# node columns a thread of each build
NODES = {"one node": 1, "three nodes": 3}
# runs at 150^3: tag -> (build, grid): "fitted" is the card's resident
# blocks (v1_geometry), "segments" ten blocks a column tile (runs of ~15
# planes, several waves, as the old v1's 16-plane segments), k: k blocks an SM
# (fewer warps a scheduler, each block marching more planes)
LEVER_RUNS = {"shipped": ("shipped", "fitted"),
              "shipped, segments": ("shipped", "segments"),
              "shipped, 2 an SM": ("shipped", 2),
              "shipped, 1 an SM": ("shipped", 1),
              **{tag: (tag, "fitted") for tag in LEVERS}}
# builds whose march loop's SASS goes to chiprun_out/
SASS_DUMPS = ("old v1", "shipped")


def levers(torch, np, parent_csrc: Path, K, sms: int) -> None:
    """The shipped v1 and its lever builds against the old v1: bits, times in
    turns at 150^3, registers, blocks an SM, SASS mix of the march loop."""
    import chip_smoke
    from kernel_builds import source_launch_args
    from pcg_mpi_solver_tpu_torch.ops import kernels
    from pcg_mpi_solver_tpu_torch.ops import structured_matvec as smv

    old_src = parent_csrc / f"{PREFIX}.cu"
    paths = {"old v1": build(old_src, OUT, "old_v1"),
             "shipped": kernels.library_path(PREFIX)}
    for rep in kernels.build_kernels([PREFIX]).values():
        for line in rep["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"build shipped: {line.strip()}")
    for tag, edits in LEVERS.items():
        src = patched(CSRC, tag.replace(", ", "_").replace(" ", "_"), edits)
        paths[tag] = build(src, OUT, src.parent.name)
    libs = {tag: load(path, PREFIX, ("f32",), 5 if tag == "old v1" else 6)
            for tag, path in paths.items()}
    stream = torch.cuda.current_stream().cuda_stream
    per_sm = {}
    for tag, h in libs.items():
        getattr(h, f"{PREFIX}_stage_f32")(K.data_ptr(), 0, stream)
        regs = registers(paths[tag])
        if tag == "old v1":
            per_sm[tag] = blocks_by_registers(regs, OLD_THREADS)
        else:
            h.structured_matvec_v1_blocks_per_sm.argtypes = [ctypes.c_int]
            per_sm[tag] = h.structured_matvec_v1_blocks_per_sm(0)
        print(f"levers: {tag}: {regs} registers, {per_sm[tag]} blocks an "
              f"SM")

    def blocks(build_tag, grid, shape):
        nodes = NODES.get(build_tag, smv.V1_NODES)
        P, nx, ny, nz = shape
        tiles = -(-P * (ny + 1) * -(-(nz + 1) // nodes) // smv.V1_THREADS)
        if grid == "segments":
            return tiles * -(-(nx + 1) // OLD_SEGMENT)
        per = per_sm[build_tag] if grid == "fitted" else grid
        return min(sms * per, tiles * (nx + 1))

    def run_of(tag, x, ck, shape):
        if tag == "old v1":
            return runner(torch, libs[tag], source_launch_args(
                torch, old_src, "v1"), x, ck, shape, sms)
        build_tag, grid = LEVER_RUNS[tag]
        n = blocks(build_tag, grid, shape)
        return runner(torch, libs[build_tag], lambda *a: (n,), x, ck, shape,
                      sms)

    rng = np.random.default_rng(0)
    shapes = [(1, 7, 3, 5), (2, 33, 17, 9), (2, 6, 5, 40)] \
        + list(chip_smoke.V1_EDGE_SHAPES) + [(1, N, N, N)]
    for shape in shapes:
        x, ck = data(torch, np, rng, shape)
        y2 = run_of("old v1", x, ck, shape)().clone()
        same = {tag: torch.equal(run_of(tag, x, ck, shape)(), y2)
                for tag in LEVER_RUNS}
        print(f"levers bits against the old v1 at {shape}: {same}")
        if shape == (1, N, N, N):
            runs = {tag: run_of(tag, x, ck, shape)
                    for tag in ["old v1", *LEVER_RUNS]}
            print(f"levers ms at {N}^3 in turns, L2 flushed: "
                  f"{in_turns(torch, runs)}")
            n = {t: blocks(*LEVER_RUNS[t], shape) for t in LEVER_RUNS}
            print(f"levers blocks at {N}^3: {n}")
            for tag in ("old v1", "shipped"):
                s = clocks_under_load(torch, runs[tag])
                print(f"levers {tag} back to back at {N}^3: SM clock MHz, "
                      f"power W sampled {s}; median clock "
                      f"{statistics.median(c for c, _w in s):.0f} MHz")
        del x, ck, y2
    for tag, path in paths.items():
        for _name, code in sass_functions(path).items():
            body = inner_loop(code) or code
            print(f"sass {tag} march loop: {mix(body)}")
            print(f"sass {tag} whole kernel: {mix(code)}")
            if tag in SASS_DUMPS:
                dump = ROOT / "chiprun_out" / (
                    f"v1_loop_{tag.replace(' ', '_')}.sass")
                dump.parent.mkdir(exist_ok=True)
                dump.write_text("\n".join(line for _a, _o, line in body))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True,
                    help="a csrc directory holding the old v1")
    ap.add_argument("--apportion", action="store_true",
                    help="split the old v1 time at 150^3")
    ap.add_argument("--levers", action="store_true",
                    help="the shipped v1 and its lever builds against the "
                         "old v1")
    ap.add_argument("--parent-bits", action="store_true",
                    help="every variant's bits against --parent")
    ap.add_argument("--probe", action="store_true",
                    help="cycles a warp FFMA of the constant-bank product")
    ap.add_argument("--flagship", action="store_true",
                    help="solve the 150^3 flagship under v1 and v6")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("v1_kernel_compare: no CUDA device", file=sys.stderr)
        return 1
    from pcg_mpi_solver_tpu_torch.models.element import unit_element_library
    from pcg_mpi_solver_tpu_torch.ops import structured_matvec as smv

    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: "
          f"{nvidia_smi()}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    K = torch.as_tensor(unit_element_library(0.2)["Ke"],
                        dtype=torch.float32, device="cuda")
    if args.apportion:
        apportion(torch, np, args.parent, K, sms)
    if args.levers:
        levers(torch, np, args.parent, K, sms)
    if args.parent_bits:
        parent(torch, np, args.parent, tuple(smv.VARIANTS), sms, OUT,
               timed=(("v1", None),))
    if args.probe:
        smem_probe(torch, sms, OUT, ("FFMA", "FFMA of Ke in registers",
                                     "FFMA of Ke in a constant bank"))
    if args.flagship:
        flagship(torch, ("v1", "v6"))
    print(nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
