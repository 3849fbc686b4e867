"""Helpers of the kernel comparison tools (tools/v4_kernel_compare.py,
tools/v5_kernel_compare.py, tools/v6_kernel_compare.py,
tools/v9_kernel_compare.py, tools/v2v3_kernel_compare.py,
tools/v7v8_kernel_compare.py, tools/v1_kernel_compare.py): build a
kernel source with nvcc under other flags, load a build's C entry
points, time a launch with CUDA events, count a build's SASS
instructions (whole kernels, their hottest loop or innermost FFMA loop)
and their opcode classes, read a build's registers, run the SM
throughput probe (tools/smem_probe.cu), hold kernels against the same
kernels built from an earlier commit's sources (with this tree's C
interface or, for v1, the one of commit 1aab56a), solve the flagship
under chosen variants and read the card's name and power limit."""

from __future__ import annotations

import collections
import concurrent.futures
import ctypes
import os
import re
import statistics
import subprocess
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "pcg_mpi_solver_tpu_torch" / "csrc"
# SASS opcodes counted as integer and address arithmetic
INTEGER = ("IMAD", "IADD3", "LEA", "ISETP", "LOP3", "SHF", "VIADD", "IABS",
           "SEL", "IMNMX", "VIMNMX", "PRMT", "UIMAD", "UIADD3", "ULEA")


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def build(src: Path, out_dir: Path, name: str, defines=()) -> Path:
    """Compiles ``src`` with the port's flags plus ``defines`` into
    ``out_dir/name.so`` and prints its registers and spills."""
    from pcg_mpi_solver_tpu_torch.ops.kernels import NVCC_FLAGS, nvcc_path
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / f"{name}.so"
    proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, *defines, "-I",
                           str(CSRC), "-o", str(lib), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}"
                           f"{proc.stderr}")
    for line in (proc.stdout + proc.stderr).splitlines():
        if "registers" in line or "spill" in line:
            print(f"build {name}: {line.strip()}")
    return lib


def load(lib: Path, prefix: str, suffixes, n_ints: int) -> ctypes.CDLL:
    """Loads a built library and declares, for each dtype suffix, its
    ``{prefix}_stage_{sfx}(ke, device, stream)`` and
    ``{prefix}_{sfx}(x, ck, y, <n_ints ints>, stream)`` entry points."""
    h = ctypes.CDLL(str(lib))
    for sfx in suffixes:
        stage = getattr(h, f"{prefix}_stage_{sfx}")
        stage.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        fn = getattr(h, f"{prefix}_{sfx}")
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * n_ints \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return h


def entry_ints(src: Path, prefix: str, sfx: str = "f32") -> int:
    """The int parameters of the C entry point ``{prefix}_{sfx}`` in
    ``src``: (P, nx, ny, nz), its launch arguments, the device."""
    m = re.search(rf'extern "C" int {prefix}_{sfx}\((.*?)\)',
                  src.read_text(), re.S)
    if m is None:
        raise RuntimeError(f"{src} has no entry point {prefix}_{sfx}")
    return len(re.findall(r"\bint\b", m.group(1)))


def source_launch_args(torch, src: Path, variant: str):
    """``launch_args``-like function for a build of ``src``, an earlier
    commit's source of ``variant``: this tree's ``launch_args`` where the
    source's entry point takes them, none where it takes only (P, nx, ny,
    nz, device), as the v1 of commit 1aab56a does."""
    from pcg_mpi_solver_tpu_torch.ops import structured_matvec as smv
    n = entry_ints(src, smv.VARIANTS[variant][0])
    if n == 5:
        return lambda *args, **kw: ()
    this = 5 + len(smv.launch_args(variant, 1, 1, 1, 1, torch.float32, 8))
    if n != this:
        raise RuntimeError(f"{src} takes {n} ints, neither the old v1's "
                           f"interface (5) nor this tree's ({this})")
    return smv.launch_args


def resource_usage(lib: Path) -> dict:
    """{kernel (mangled name): {"REG": registers, "STACK", "SHARED",
    "LOCAL", ...}} of ``lib`` (cuobjdump -res-usage)."""
    from pcg_mpi_solver_tpu_torch.ops.kernels import nvcc_path
    dump = Path(nvcc_path()).with_name("cuobjdump")
    out = subprocess.run([str(dump), "-res-usage", str(lib)],
                         capture_output=True, text=True).stdout
    usage, name = {}, None
    for line in out.splitlines():
        m = re.match(r"\s*Function (\S+):", line)
        if m:
            name = m.group(1)
        elif name and "REG:" in line:
            usage[name] = {k: int(v) for k, v in
                           re.findall(r"(\w+):(\d+)", line)}
            name = None
    return usage


def blocks_by_registers(regs: int, threads: int) -> int:
    """Blocks of ``threads`` an H100 SM holds at ``regs`` registers a
    thread, with no shared memory: 65,536 registers given out a warp at
    a time in units of 256, at most 64 warps and 32 blocks."""
    warps = -(-threads // 32)
    per_warp = -(-regs * 32 // 256) * 256
    return min(32, 64 // warps, 65536 // (per_warp * warps))


def time_ms(torch, fn, reps: int = 25) -> float:
    """Median CUDA-event time of one call, L2 flushed before each."""
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def sass_functions(lib: Path) -> dict:
    """{kernel (mangled name): [(address, opcode, line), ...]} of ``lib``'s
    SASS (cuobjdump -sass)."""
    from pcg_mpi_solver_tpu_torch.ops.kernels import nvcc_path
    dump = Path(nvcc_path()).with_name("cuobjdump")
    out = subprocess.run([str(dump), "-sass", str(lib)], capture_output=True,
                         text=True).stdout
    funcs = {}
    for body in re.split(r"\n\s*Function : ", out)[1:]:
        name = body.split("\n", 1)[0].strip()
        code = []
        for line in body.splitlines():
            m = re.match(r"\s*/\*([0-9a-f]+)\*/\s+(@!?U?P\w+\s+)?"
                         r"([A-Z][A-Z0-9_]*)", line)
            if m:
                code.append((int(m.group(1), 16), m.group(3), line))
        funcs[name] = code
    return funcs


def opcode_counts(code) -> collections.Counter:
    """Opcode (without its modifiers) -> count, over ``code``."""
    return collections.Counter(op for _addr, op, _line in code)


def loop_body(code):
    """The instructions of the loop of ``code`` that holds the most FFMAs
    (the smallest such loop), a loop being the span from a backward
    branch's target to the branch; None if there is no backward branch."""
    best = None
    for addr, op, line in code:
        m = re.search(r"\bBRA[.\w]*\s+(?:`?\(?)0x([0-9a-f]+)", line)
        if op != "BRA" or not m or int(m.group(1), 16) > addr:
            continue
        span = [c for c in code if int(m.group(1), 16) <= c[0] <= addr]
        key = (opcode_counts(span)["FFMA"], -len(span))
        if best is None or key > best[0]:
            best = (key, span)
    return None if best is None else best[1]


# opcode -> class, for the mix of a loop by class (the rest: "other")
CLASSES = {"FFMA": "FFMA", "FMUL": "float", "FADD": "float",
           "LDG": "LDG", "STG": "STG", "MOV": "MOV", "ULDC": "ULDC",
           "LDC": "LDC", "BRA": "branch", "BSSY": "branch",
           "BSYNC": "branch", "WARPSYNC": "branch", "EXIT": "branch",
           "BREAK": "branch", "CALL": "branch", "RET": "branch"}


def opcode_classes(code) -> collections.Counter:
    """Instructions of ``code`` by class: FFMA, float (FMUL, FADD), integer
    and address arithmetic (INTEGER; an IMAD.MOV counts as MOV), LDG, STG,
    MOV, ULDC, LDC, branch, other; and "FFMA c[]", the FFMAs with a
    constant-bank operand."""
    out = collections.Counter()
    for _addr, op, line in code:
        if op == "IMAD" and "IMAD.MOV" in line:
            cls = "MOV"
        elif op in INTEGER:
            cls = "integer"
        else:
            cls = CLASSES.get(op, "other")
        out[cls] += 1
        if op == "FFMA" and re.search(r"\bc\[0x[0-9a-f]+\]", line):
            out["FFMA c[]"] += 1
    return out


def inner_loop(code):
    """The instructions of the innermost loop of ``code`` (one that holds
    no other loop) with the most FFMAs; None if there is no backward
    branch.  Where a kernel nests its FFMA loop in another (v1's march
    in its walk of runs), loop_body picks the outer one."""
    loops = []
    for addr, op, line in code:
        m = re.search(r"\bBRA[.\w]*\s+(?:`?\(?)0x([0-9a-f]+)", line)
        if op == "BRA" and m and int(m.group(1), 16) <= addr:
            loops.append((int(m.group(1), 16), addr))
    inner = [(lo, hi) for lo, hi in loops
             if not any((lo, hi) != (a, b) and lo <= a and b <= hi
                        for a, b in loops)]
    spans = [[c for c in code if lo <= c[0] <= hi] for lo, hi in inner]
    return max(spans, key=lambda s: opcode_counts(s)["FFMA"], default=None)


def shared_widths(code) -> collections.Counter:
    """Shared-memory loads and stores of ``code`` by opcode with its width
    (LDS, LDS.64, LDS.128, STS.128, ...)."""
    widths = collections.Counter()
    for _addr, op, line in code:
        if op in ("LDS", "STS"):
            m = re.search(r"\b(%s(?:\.[A-Z0-9]+)*)" % op, line)
            width = re.search(r"\.(64|128)\b", m.group(1))
            widths[op + (f".{width.group(1)}" if width else "")] += 1
    return widths


def mix_line(ops: collections.Counter, keys) -> str:
    """Total, instructions per FFMA and the counts of ``keys`` (and of
    integer arithmetic) in ``ops``."""
    total = sum(ops.values())
    shown = {k: ops[k] for k in keys if ops[k]}
    shown["integer"] = sum(ops[k] for k in INTEGER)
    per = f"{total / ops['FFMA']:.3f}" if ops["FFMA"] else "n/a"
    return f"{total} instructions, {per} per FFMA; {shown}"


def sass_mix(lib: Path, tag: str, label, keys) -> None:
    """Prints the static count of each opcode in ``keys`` (and of integer
    arithmetic) per kernel of ``lib``; ``label(mangled name)`` names it."""
    for name, code in sass_functions(lib).items():
        ops = opcode_counts(code)
        shown = {k: ops[k] for k in keys if ops[k]}
        shown["integer"] = sum(ops[k] for k in INTEGER)
        print(f"sass {tag}{label(name)}: {sum(ops.values())} instructions; "
              f"{shown}")


PROBE_MODES = ("LDS.32 broadcast", "LDS.128 broadcast", "LDS.32 lanes",
               "LDS.128 lanes", "SHFL.UP", "FFMA",
               "FFMA of Ke broadcast", "FFMA of Ke in registers",
               "FFMA of Ke in a constant bank",
               "FFMA of Ke as a kernel parameter")
# warp instructions a thread issues per probe iteration: 16, or the FFMAs
# of the modes that time a cell product's pattern
PROBE_COUNT = {"FFMA of Ke broadcast": 128, "FFMA of Ke in registers": 128,
               "FFMA of Ke in a constant bank": 1152,
               "FFMA of Ke as a kernel parameter": 1152}


def smem_probe(torch, sms: int, out_dir: Path, modes=PROBE_MODES) -> dict:
    """SM cycles one warp instruction takes, per tools/smem_probe.cu mode
    named in ``modes``: two 256-thread blocks an SM, each thread issuing 16
    x 2048 of them (PROBE_COUNT x 2048 FFMAs in the modes of a cell
    product's pattern, which count the cycles an FFMA); for each SM, the
    span from its first block's start to its last block's end over its
    warps' instructions; the median over the SMs.  Builds the probe into
    ``out_dir``."""
    path = build(ROOT / "tools" / "smem_probe.cu", out_dir, "smem_probe")
    h = ctypes.CDLL(str(path))
    h.smem_probe.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4
    h.smem_probe.restype = ctypes.c_int
    blocks, iters = 2 * sms, 2048
    out = torch.empty(blocks * 256, device="cuda")
    clocks = torch.empty(2 * blocks, dtype=torch.int64, device="cuda")
    sm = torch.empty(blocks, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    costs = {}
    for name in modes:
        mode = PROBE_MODES.index(name)
        for _ in range(2):                       # the second run counts
            err = h.smem_probe(mode, iters, blocks, out.data_ptr(),
                               clocks.data_ptr(), sm.data_ptr(), stream)
            if err:
                raise RuntimeError(f"smem_probe mode {mode}: error {err}")
        torch.cuda.synchronize()
        c = clocks.view(-1, 2).cpu().tolist()
        spans = collections.defaultdict(list)
        for (t0, t1), s in zip(c, sm.cpu().tolist()):
            spans[s].append((t0, t1))
        count = PROBE_COUNT.get(name, 16)
        per_sm = [(max(t1 for _t0, t1 in v) - min(t0 for t0, _t1 in v))
                  / (8 * len(v) * iters * count) for v in spans.values()]
        costs[name] = statistics.median(per_sm)
        if name == modes[0]:
            counts = collections.Counter(len(v) for v in spans.values())
            print(f"probe: blocks an SM {dict(counts)} over {len(spans)} "
                  f"SMs")
    print(f"probe, SM cycles a warp instruction: "
          f"{ {k: round(v, 3) for k, v in costs.items()} }")
    return costs


def parent(torch, np, csrc: Path, variants, sms: int, out_dir: Path,
           timed=(("v6", None),)) -> dict:
    """Each of ``variants`` against the same kernel built from ``csrc`` (an
    earlier commit's csrc directory, with this one's C interface or, for
    v1, the old one's: ``source_launch_args``): bits at
    every shape chip_smoke.py holds it to (the chunked ones at 8 and 16
    planes, v6 in both dtypes), and the float32 times at 150^3 of the
    ``timed`` (variant, planes) in turns (parent, this, this, parent).
    Returns {variant: the path of the parent's build}."""
    import chip_smoke
    from pcg_mpi_solver_tpu_torch.models.element import unit_element_library
    from pcg_mpi_solver_tpu_torch.ops import structured_matvec as smv

    sources = {v: csrc / f"{smv.VARIANTS[v][0]}.cu" for v in variants}
    dtypes = {v: ("f32", "f64") if v == smv.F64_VARIANT else ("f32",)
              for v in variants}
    with concurrent.futures.ThreadPoolExecutor() as pool:
        jobs = {v: pool.submit(build, src, out_dir, f"parent_{v}")
                for v, src in sources.items()}
        paths = {v: job.result() for v, job in jobs.items()}
    # the pointers, then (P, nx, ny, nz), the launch arguments, the device
    args = {v: source_launch_args(torch, src, v)
            for v, src in sources.items()}
    libs = {v: load(paths[v], smv.VARIANTS[v][0], dtypes[v],
                    5 + len(args[v](v, 1, 1, 1, 1, torch.float32, 8)))
            for v in variants}
    stream = torch.cuda.current_stream().cuda_stream
    rng = np.random.default_rng(1)
    Ke = unit_element_library(0.2)["Ke"]
    shapes = chip_smoke.kernel_shapes()
    for dtype, sfx in ((torch.float32, "f32"), (torch.float64, "f64")):
        K = torch.as_tensor(Ke, dtype=dtype, device="cuda")
        runs = [(v, pl) for v in variants
                for pl in ((8, 16) if smv.VARIANTS[v][1] else (None,))
                if sfx in dtypes[v]]
        for v in dict(runs):
            for h in (libs[v], smv._library(v)):
                getattr(h, f"{smv.VARIANTS[v][0]}_stage_{sfx}")(
                    K.data_ptr(), 0, stream)
        verdicts = collections.defaultdict(list)
        for shape in shapes[str(dtype).removeprefix("torch.")]:
            P, nx, ny, nz = shape
            x = torch.as_tensor(rng.standard_normal((P, 3, nx + 1, ny + 1,
                                                     nz + 1)),
                                dtype=dtype, device="cuda")
            ck = torch.as_tensor(rng.uniform(1, 10, (P, nx, ny, nz)),
                                 dtype=dtype, device="cuda")
            for v, pl in runs:
                pair = {}
                for tag, h, launch_args in (
                        ("this", smv._library(v), smv.launch_args),
                        ("parent", libs[v], args[v])):
                    fn = getattr(h, f"{smv.VARIANTS[v][0]}_{sfx}")
                    y = torch.empty_like(x)
                    extra = launch_args(v, *shape, dtype, pl, sms)

                    def run(fn=fn, y=y, v=v, extra=extra):
                        err = fn(x.data_ptr(), ck.data_ptr(), y.data_ptr(),
                                 P, nx, ny, nz, *extra, 0, stream)
                        if err:
                            raise RuntimeError(f"{v} launch failed: {err}")
                        return y
                    pair[tag] = run
                verdicts[(v, pl)].append(
                    (shape, torch.equal(pair["this"](), pair["parent"]())))
                if shape == (1, 150, 150, 150) and sfx == "f32" \
                        and (v, pl) in timed:
                    t = collections.defaultdict(list)
                    for tag in ("parent", "this", "this", "parent"):
                        t[tag].append(round(time_ms(torch, pair[tag]), 4))
                    at = "" if pl is None else f" at {pl} planes"
                    print(f"parent {v} {sfx}{at} ms at 150^3 in turns: "
                          f"{dict(t)}")
            del x, ck
        for (v, pl), vs in verdicts.items():
            at = "" if pl is None else f" at {pl} planes"
            bad = [s for s, same in vs if not same]
            verdict = f"DIFFERENT at {bad}" if bad \
                else f"same at all {len(vs)} shapes"
            print(f"parent bits {v} {sfx}{at}: {verdict}")
        torch.cuda.empty_cache()
    return paths


def flagship(torch, variants) -> None:
    """The 150^3 mixed solve of chip_smoke.py under each of ``variants`` in
    turn, each with flag, iterations, relres, inner cycles, ms/iter and
    launch counts."""
    import chip_smoke
    from pcg_mpi_solver_tpu_torch import RunConfig, SolverConfig
    from pcg_mpi_solver_tpu_torch.models import make_cube_model
    from pcg_mpi_solver_tpu_torch.ops.structured_matvec import (
        LAUNCHES, reset_launch_counts)
    from pcg_mpi_solver_tpu_torch.solver import Solver

    kw = dict(chip_smoke.FLAGSHIP)
    model = make_cube_model(kw.pop("nx"), **kw)
    cfg = RunConfig(solver=SolverConfig(tol=1e-7, precision_mode="mixed"))
    for variant in variants:
        os.environ["PCG_TPU_PALLAS_V"] = variant.removeprefix("v")
        try:
            solver = Solver(model, cfg)
        finally:
            del os.environ["PCG_TPU_PALLAS_V"]
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        with chip_smoke.inner_cycles() as cycles:
            results = solver.solve()
        total = time.perf_counter() - t0
        res = results[-1]
        wall = sum(r.wall_s for r in results)
        iters = sum(r.iters for r in results)
        print(f"flagship {variant}: flag {res.flag}, iterations {res.iters}, "
              f"relres {res.relres:.4e}, inner cycles {cycles}, solve wall "
              f"{wall:.3f} s ({total:.3f} s around solve()), "
              f"{wall / iters * 1e3:.4f} ms/iter; launches "
              f"{ {f'{v} {d}': n for (v, d), n in LAUNCHES.items() if n} }")
        del solver
        torch.cuda.empty_cache()
