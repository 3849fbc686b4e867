#!/usr/bin/env python3
"""Compare the port's v7 and v8 structured-matvec kernels with the kernels
they replaced and with the kernels they share a design with (v7 v5's
node-owned gather, v8 v6 float's tile kernel), on one NVIDIA card, and
apportion the time of the tile kernel among the phases of a plane.

Run from the repository root, on a machine with the card and nvcc:

    mkdir -p build/parent && git archive 97506cc \\
        pcg_mpi_solver_tpu_torch/csrc | tar -x -C build/parent
    python3 tools/v7v8_kernel_compare.py \\
        --old-v7 build/parent/pcg_mpi_solver_tpu_torch/csrc/structured_matvec_v7.cu \\
        --old-v8 build/parent/pcg_mpi_solver_tpu_torch/csrc/structured_matvec_v8.cu \\
        --parent build/parent/pcg_mpi_solver_tpu_torch/csrc --flagship

(97506cc holds v7 as warp shuffles and v8 as a thread a cell of 8 x 32
tiles with eight placement barriers a plane.  7117d72 holds v8 as a
split-phase tile, two product buffers and one barrier a plane on a 24 x
32-cell tile, and this tool's sweep of it.)

Prints:
  * whether v8 gives v6 float's bits and v7 gives v5's (8 and 16 planes),
    at the card tests' shapes, the edge shapes of chip_smoke.py and 150^3,
    and whether the phase-probe build of v6 gives the shipped build's
    bits (v8 compiles the same kernel);
  * whether the shipped v6 library has the SASS of a build whose source
    has the probe's hook lines taken out (the hook compiles to
    nothing), and, with --parent, whether v6's SASS is the parent's (the
    first differing instructions where not);
  * at the flagship slab (1 part, 150^3 cells), each kernel's error
    against the float64 plain version (max, rms and mean, over max|y|) and
    against the float32 plain version (2e-5 x max|y|), whether two
    launches give the same bits, and CUDA-event times with L2 flushed,
    median of 25, in turns (then the reverse order), each launched through
    its C entry point: v8, the old v8 (8 planes) and v6 float; v7, the old
    v7 and v5 at 8 planes, then at 16; then the probe build of v6 (the
    probe's own cost); then v6 and v5 each with four output
    buffers of its own (whether where y lies moves the time);
  * the phase apportionment: from the probe build at 150^3, each warp's
    SM-clock cycles in each phase of its planes (the block's start; the
    copies' issue; the ring wait; the barrier before the product; the
    product; the barrier after it; placement and stores), the median
    over blocks of each phase's share of the block's warp-cycles and of
    its cycles a plane, and the verdict on the barrier hypothesis (v6's
    barriers and ring waits under 15 % of its time refute it);
  * each build's registers and spills (ptxas), shared memory, and the
    SASS instruction mix (cuobjdump, static counts) of the loop that holds
    each kernel's FFMAs and of the whole kernel: FFMA, LDS, STS, BAR
    (barriers a plane in the loop), integer, instructions per FFMA;
  * with --parent, whether every other kernel (v1-v6, v9; v6 in both
    dtypes; the chunked ones at 8 and 16 planes) gives the bits of that
    directory's sources at every shape chip_smoke.py holds it to
    (kernel_builds.parent), the v6 float time of both in turns (parent,
    this, this, parent), and whether v6's SASS is the parent's;
  * with --flagship, the 150^3 mixed solve under v7, v8 and v6, each with
    flag, iterations, relres, inner cycles, ms/iter and launch counts.
--old-v7 and --old-v8 take sources with the replaced kernels' C
interface, (P, nx, ny, nz, planes, device); a source beside its own
headers, such as one unpacked from an earlier commit, is built with
those.  Builds go to build/v7v8_compare/.
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures
import ctypes
import difflib
import re
import shutil
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

from kernel_builds import (  # noqa: E402
    CSRC, build, flagship, load, loop_body, mix_line, nvidia_smi,
    opcode_counts, parent, sass_functions, shared_widths, time_ms)

OUT = ROOT / "build" / "v7v8_compare"
N = 150
PLANES = (8, 16)
# the card tests' shapes (tests/test_torch_cuda.py), chip_smoke.py's edge
# shapes and the flagship slab
SHAPES = ((1, 7, 3, 5), (2, 33, 17, 9), (1, 1, 1, 1), (2, 6, 5, 40),
          (2, 40, 37, 70), (1, 20, 70, 40), (1, 100, 200, 200), (1, N, N, N))
SASS_KEYS = ("FFMA", "LDS", "STS", "STG", "LDGSTS", "LDG", "SHFL", "BAR",
             "MOV", "LDL", "STL")
# the phases of csrc/structured_tiles.cuh's enum Phase, in its order
PHASES = ("start", "issue", "wait", "barrier", "product", "barrier 2",
          "placement")
# a probe line: a statement of the hook, taken out for the no-hook builds
HOOK = re.compile(r"^\s*SMV_PHASE\w*\(.*\);\s*$")
# the probe builds: variant -> source
PROBED = {"v6": "structured_matvec.cu"}
# --parent: the kernels other than v7 and v8
PARENT = ("v1", "v2", "v3", "v4", "v5", "v6", "v9")


def sass_text(path: Path) -> dict:
    """{kernel: [instruction, ...]} of a library, addresses and encodings
    dropped, for comparing two builds.  A kernel is named by its cell
    product (DmmaProduct, FfmaProduct), which is one a library; the
    mangled name also holds a hash of the source's path and the product's
    template arguments."""
    out = {}
    for name, code in sass_functions(path).items():
        m = re.search(r"(Dmma|Ffma)Product", name)
        out[m.group(0) if m else name] = [
            re.sub(r"/\*[^*]*\*/", "", line).split(";")[0].strip()
            for _addr, _op, line in code]
    return out


def sass_verdict(a: Path, b: Path) -> str:
    """'the same', or how the SASS of two builds differs: each kernel's
    instruction counts and its first differing instructions."""
    ta, tb = sass_text(a), sass_text(b)
    if ta == tb:
        return "the same"
    out = [f"DIFFERENT (kernels {sorted(ta)} against {sorted(tb)})"
           if sorted(ta) != sorted(tb) else "DIFFERENT"]
    for name in sorted(set(ta) & set(tb)):
        if ta[name] == tb[name]:
            continue
        diff = [d for d in difflib.unified_diff(ta[name], tb[name], n=0,
                                                lineterm="")
                if d[:1] in "+-" and d[:3] not in ("---", "+++")]
        out.append(f"{name[-60:]}: {len(ta[name])} against {len(tb[name])} "
                   f"instructions, {len(diff)} lines differ, first "
                   f"{diff[:6]}")
    return "; ".join(out)


def no_hook_csrc() -> Path:
    """A copy of csrc/ whose structured_tiles.cuh has the phase probe's
    hook lines taken out."""
    dst = OUT / "nohook"
    shutil.rmtree(dst, ignore_errors=True)
    dst.mkdir(parents=True)
    for src in CSRC.iterdir():
        text = src.read_text()
        if src.name == "structured_tiles.cuh":
            lines = text.splitlines(keepends=True)
            kept = [ln for ln in lines if not HOOK.match(ln)]
            if len(lines) - len(kept) != 9:
                raise RuntimeError(f"found {len(lines) - len(kept)} hook "
                                   f"lines in {src.name}")
            text = "".join(kept)
        (dst / src.name).write_text(text)
    return dst


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old-v7", type=Path, help="the replaced v7 source")
    ap.add_argument("--old-v8", type=Path, help="the replaced v8 source")
    ap.add_argument("--parent", type=Path,
                    help="a csrc directory of an earlier commit whose "
                         "other kernels' bits and v6 time to compare")
    ap.add_argument("--flagship", action="store_true",
                    help="solve the 150^3 flagship under v7, v8 and v6")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("v7v8_kernel_compare: no CUDA device", file=sys.stderr)
        return 1
    from pcg_mpi_solver_tpu_torch.models.element import unit_element_library
    from pcg_mpi_solver_tpu_torch.ops import kernels
    from pcg_mpi_solver_tpu_torch.ops import structured_matvec as smv

    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: "
          f"{nvidia_smi()}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    names = {v: smv.VARIANTS[v][0] for v in ("v5", "v6", "v7", "v8")}
    for name, rep in kernels.build_kernels(list(names.values())).items():
        for line in rep["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"build {name}: {line.strip()}")
    # tag -> (library path, handle, C prefix, variant whose launch
    # arguments it takes, or None for the old kernels' (planes,))
    libs = {v: (kernels.library_path(n), smv._library(v), n, v)
            for v, n in names.items()}
    nohook = no_hook_csrc()
    with concurrent.futures.ThreadPoolExecutor() as pool:
        jobs = {}
        for v, src in PROBED.items():
            jobs[f"probe {v}"] = (pool.submit(
                build, CSRC / src, OUT, f"probe_{v}",
                ("-DSMV_PHASE_PROBE",)), names[v], v)
            jobs[f"nohook {v}"] = (pool.submit(
                build, nohook / src, OUT, f"nohook_{v}"), names[v], v)
        for v, path in (("v7", args.old_v7), ("v8", args.old_v8)):
            if path is not None:
                jobs[f"old {v}"] = (pool.submit(build, path, OUT, f"old_{v}"),
                                    names[v], None)
        for tag, (job, prefix, like) in jobs.items():
            path = job.result()
            # the old kernels take (P, nx, ny, nz, planes, device), the
            # tile kernels (P, nx, ny, nz, seg_len, n_ty, n_tz, n_seg,
            # device)
            h = load(path, prefix, ("f32", "f64") if like == "v6"
                     else ("f32",), 6 if like is None else 9)
            libs[tag] = (path, h, prefix, like)
    print(f"shared memory: v8 "
          f"{libs['v8'][1].structured_matvec_v8_smem_bytes(4)} B, v6 float "
          f"{libs['v6'][1].structured_matvec_smem_bytes(4)} B; v7 and v5 "
          f"at 8 planes, 8 rows {smv.v5_smem_bytes(8, 8)} B, at 16 "
          f"{smv.v5_smem_bytes(16, 8)} B")

    # the hook compiles to nothing: the shipped libraries' SASS is that of
    # builds without the hook lines
    for v in PROBED:
        verdict = sass_verdict(libs[v][0], libs[f"nohook {v}"][0])
        print(f"sass {v} shipped against its source without the probe's "
              f"hook lines: {verdict}")

    Ke = unit_element_library(0.2)["Ke"]
    K = torch.as_tensor(Ke, dtype=torch.float32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rng = np.random.default_rng(0)
    for _path, h, prefix, _like in libs.values():
        getattr(h, f"{prefix}_stage_f32")(K.data_ptr(), 0, stream)
    probe_buf = torch.zeros(1 << 20, dtype=torch.int32, device="cuda")
    for v in [t for t in libs if t.startswith("probe ")]:
        h = libs[v][1]
        h.smv_phase_probe_buffer.argtypes = [ctypes.c_void_p]
        err = h.smv_phase_probe_buffer(probe_buf.data_ptr())
        if err:
            raise RuntimeError(f"probe {v}: buffer error {err}")

    def data(shape):
        P, nx, ny, nz = shape
        x = torch.as_tensor(rng.standard_normal((P, 3, nx + 1, ny + 1,
                                                 nz + 1)),
                            dtype=torch.float32, device="cuda")
        ck = torch.as_tensor(rng.uniform(1, 10, (P, nx, ny, nz)),
                             dtype=torch.float32, device="cuda")
        return x, ck

    def runner(tag, x, ck, shape, planes=None):
        _path, h, prefix, like = libs[tag]
        P, nx, ny, nz = shape
        extra = (smv.launch_args(like, *shape, torch.float32, planes, sms)
                 if like else (planes,))
        fn = getattr(h, f"{prefix}_f32")
        y = torch.empty_like(x)

        def run():
            err = fn(x.data_ptr(), ck.data_ptr(), y.data_ptr(), P, nx, ny,
                     nz, *extra, 0, stream)
            if err:
                raise RuntimeError(f"{tag} launch failed: {err}")
            return y
        run.y = y
        return run

    verdicts = collections.defaultdict(list)
    for s in SHAPES:
        x, ck = data(s)
        y6 = runner("v6", x, ck, s)().clone()
        y8 = runner("v8", x, ck, s)().clone()
        verdicts["v8 = v6 float"].append((s, torch.equal(y8, y6)))
        verdicts["probe v6 = v6"].append(
            (s, torch.equal(y6, runner("probe v6", x, ck, s)())))
        for pl in PLANES:
            verdicts[f"v7 = v5 at {pl} planes"].append(
                (s, torch.equal(runner("v7", x, ck, s, pl)(),
                                runner("v5", x, ck, s, pl)())))
        del x, ck, y6, y8
    for what, v in verdicts.items():
        shown = "; ".join(f"{s} {'same' if o else 'DIFFERENT'}"
                          for s, o in v)
        print(f"bits {what}: "
              f"{'all same' if all(o for _s, o in v) else 'NOT ALL'}: "
              f"{shown}")

    shape = (1, N, N, N)
    x, ck = data(shape)
    y_ref = smv.structured_matvec_plain(x.double(), ck.double(), K.double())
    y32 = smv.structured_matvec_plain(x, ck, K)
    scale = y_ref.abs().max().item()
    groups = {"v8": [t for t in ("v8", "old v8", "v6") if t in libs]}
    for pl in PLANES:
        groups[f"v7 at {pl} planes"] = [
            t for t in ("v7", "old v7", "v5") if t in libs]
    groups["probe build"] = ["probe v6", "v6"]
    for group, tags in groups.items():
        pl = int(group.split()[2]) if group.startswith("v7") else 8
        runs = {t: runner(t, x, ck, shape, pl) for t in tags}
        for tag, run in runs.items():
            y1 = run().clone()
            same = torch.equal(y1, run())
            e = y1.double() - y_ref
            e32 = (y1 - y32).abs().max().item() / y32.abs().max().item()
            print(f"{group}: {tag}: max|err|/max|y| "
                  f"{e.abs().max().item() / scale:.3e} (float32 plain "
                  f"{e32:.3e}, tolerance 2e-5), rms "
                  f"{e.pow(2).mean().sqrt().item() / scale:.3e}, mean "
                  f"{e.mean().item() / scale:.3e}; repeat bitwise "
                  f"{'equal' if same else 'DIFFERENT'}")
        t = collections.defaultdict(list)
        for tag in list(runs) + list(runs)[::-1]:
            t[tag].append(round(time_ms(torch, runs[tag]), 4))
        print(f"kernel ms at {N}^3 ({group}), L2 flushed, in turns: "
              f"{dict(t)}")

    # where y lies: four output buffers a kernel, in turns
    for tag in ("v6", "v5"):
        runs = [runner(tag, x, ck, shape, 8) for _ in range(4)]
        t = collections.defaultdict(list)
        for i in list(range(4)) + list(range(4))[::-1]:
            t[i].append(round(time_ms(torch, runs[i]), 4))
        print(f"y placement {tag} ms at {N}^3 (x at "
              f"{x.data_ptr():#x}): " + "; ".join(
                  f"y at {runs[i].y.data_ptr():#x} {t[i]}" for i in t))
        del runs
    phases(torch, np, smv, libs, runner, probe_buf, x, ck, shape, "v6", sms)
    del x, ck, y_ref, y32
    torch.cuda.empty_cache()

    # SASS: the loop that holds each kernel's FFMAs, and the whole kernel
    g5 = smv.v5_geometry(*shape, PLANES[0], sms)
    for tag, (path, _h, _prefix, _like) in libs.items():
        if tag.startswith("nohook"):
            continue
        for name, code in sass_functions(path).items():
            if "Dmma" in name or (tag in ("v5", "v7")
                                  and f"Li{g5.rows}E" not in name):
                continue             # v6's double kernel, other tiles
            body = loop_body(code) or code
            print(f"sass {tag} loop: "
                  f"{mix_line(opcode_counts(body), SASS_KEYS)}; "
                  f"{dict(shared_widths(body))}")
            print(f"sass {tag} whole kernel: "
                  f"{mix_line(opcode_counts(code), SASS_KEYS)}")

    if args.parent is not None:
        paths = parent(torch, np, args.parent, PARENT, sms, OUT)
        print(f"sass v6 against the parent's: "
              f"{sass_verdict(paths['v6'], libs['v6'][0])}")
    if args.flagship:
        flagship(torch, ("v7", "v8", "v6"))
    print(nvidia_smi())
    return 0


def phases(torch, np, smv, libs, runner, buf, x, ck, shape, v, sms) -> None:
    """Runs the probe build of ``v`` at ``shape`` and prints the median
    over blocks of each phase's share of the block's warp-cycles and of
    its cycles a plane (a warp's, averaged over the block's warps)."""
    g = smv.v6_geometry(*shape, torch.float32, sms)
    warps = smv.V6_CELLS_Y[torch.float32] // 2
    n = g.blocks * warps * len(PHASES)
    if n > buf.numel():
        raise RuntimeError(f"probe buffer too small for {g}")
    run = runner(f"probe {v}", x, ck, shape)
    run()
    buf.zero_()
    run()
    torch.cuda.synchronize()
    cyc = (buf[:n].cpu().numpy().astype(np.int64) & 0xFFFFFFFF).reshape(
        g.blocks, warps, len(PHASES)).astype(np.float64)
    # the block's cell planes: its segment's node planes and the one before
    seg = (np.arange(g.blocks) // (g.n_ty * g.n_tz)) % g.n_seg
    x0 = seg * g.seg_len
    planes = np.minimum(x0 + g.seg_len, shape[1] + 1) - x0 + 1
    per_block = cyc.sum(axis=1)                      # [blocks, phases]
    share = per_block / per_block.sum(axis=1, keepdims=True)
    a_plane = per_block / warps / planes[:, None]
    shares = {p: float(np.median(share[:, i])) for i, p in enumerate(PHASES)}
    cycles = {p: float(np.median(a_plane[:, i]))
              for i, p in enumerate(PHASES)}
    total = float(np.median(a_plane.sum(axis=1)))
    print(f"phases {v} at {N}^3 ({g.blocks} blocks of {warps} warps, "
          f"{g.n_seg} segments of {g.seg_len} planes): median share "
          f"{ {p: round(s, 4) for p, s in shares.items()} }; median "
          f"cycles a plane a warp {round(total, 1)}: "
          f"{ {p: round(c, 1) for p, c in cycles.items()} }")
    spread = per_block.sum(axis=1) / warps
    print(f"phases {v}: a block's warp-cycles, median "
          f"{statistics.median(spread.tolist()):.0f}, min "
          f"{spread.min():.0f}, max {spread.max():.0f}")
    if v == "v6":
        held = shares["barrier"] + shares["barrier 2"] + shares["wait"]
        verdict = ("the split-phase hypothesis is refuted before the kernel "
                   "is timed" if held < 0.15 else
                   "the split-phase hypothesis stands")
        print(f"phases verdict: v6's barriers and ring waits hold "
              f"{held:.2%} of its warp-cycles (threshold 15 %): {verdict}")


if __name__ == "__main__":
    sys.exit(main())
