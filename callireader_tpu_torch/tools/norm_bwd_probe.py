"""What the RMSNorm backward's persistent grid trades, at the training paths' shapes.

``rmsnorm_bwd`` of ``csrc/rmsnorm.cu`` walks the rows with a persistent grid
of a few blocks an SM (``kernels/rmsnorm.py::BWD_BLOCKS_PER_SM``), with
``BWD_AHEAD`` rows loading while it computes one, and with dw finishes dw in
the same launch (each block's partial, one grid barrier, the partials
summed in a fixed order). This script builds the kernel as it stands and
with ``BWD_AHEAD`` = 2 (a copy of ``csrc/`` with that line changed), beside
the row-group kernel it replaced (``tests/data/rmsnorm_bwd_rows.cu``). It holds
each build to the row-group kernel (dx: the elements that differ and their
largest distance in bf16 ulps), dw to the plain version (within 1e-5 of the
sum of its terms' sizes) and both to themselves (the same bits in two runs),
at rows 1, 7, 133, 2560 and 4099, E 64, 4096 and 8192, both dtypes, both
roundings, dw on and off. Then, at E = 4096 bf16 and the rows of the e-IT
micro-step (4096) and ``llava_loss`` (2560), it times each route (model
rounding with dw off and on, fused with dw on) at 1, 2, 3 and 4 blocks an SM
(the grid balanced as the wrapper balances it), beside the row-group kernel
(plus ``torch.sum`` of its partials, with dw) and the autograd backward of
``F.rms_norm``: device us a call from torch.profiler (every kernel of the
call), ms a call from CUDA events over back-to-back calls on the same inputs
(what ``chip_smoke.py`` measures) and over calls that walk three copies of
the inputs (more than the 50 MB L2 holds: "cold"), and the host's us to
enqueue a call of the wrapper (``_bwd``). Bounds count x and dy read once, dx
written once, w, r and dw. The SASS of the bf16 model-rounding backward
without dw, as built and in the row-group kernel, goes to
``callireader_tpu_torch/_build/norm_bwd_probe/sass_{new,rows}.txt``. Run on a machine with an
NVIDIA H100 and the CUDA toolkit::

    python -m callireader_tpu_torch.tools.norm_bwd_probe

The builds go under ``callireader_tpu_torch/_build/norm_bwd_probe/``. Prints a
line per measurement, then one JSON line.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import time
from pathlib import Path

import torch
import torch.nn.functional as F

from callireader_tpu_torch.kernels import _build
from callireader_tpu_torch.kernels import rmsnorm as k

ROOT = Path(__file__).resolve().parents[2]
ROWS_SOURCE = ROOT / "tests" / "data" / "rmsnorm_bwd_rows.cu"
WORK = _build.BUILD_DIR / "norm_bwd_probe"
AHEAD_LINE = ("constexpr int BWD_AHEAD = 1;  // rows a backward block has loading while it "
              "computes one")
EDITS = {"as built": None, "ahead 2": ("rmsnorm.cu", AHEAD_LINE, "constexpr int BWD_AHEAD = 2;")}
ROWS_PER_BLOCK = 16  # the row-group kernel's rows a block with dw
PEAK_BYTES_S = 3.35e12
EPS = 1e-5


def stream():
    return torch.cuda.current_stream().cuda_stream


def rows_kernel_command(so: Path):
    """nvcc's command that builds the row-group kernel into ``so`` (the
    port's flags)."""
    return [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(so), str(ROWS_SOURCE)]


def bind_rows(so: Path):
    """The row-group kernel's entry points in the built ``so`` -> {mode: entry};
    an entry takes (x, w, r, dy, dx, dw partials or None, rows, E, rows a
    block, dtype code, stream)."""
    lib = ctypes.CDLL(str(so))
    entries = {}
    for mode in ("model", "fused"):
        fn = getattr(lib, f"rmsnorm_bwd_{mode}_launch")
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        entries[mode] = fn
    return entries


def build():
    """-> ({build: {mode: entry}}, the row-group kernel's {mode: entry}, nvcc's
    lines on the backward, the .so paths)."""
    builds = _build.build_variants(WORK / "src", EDITS, ["rmsnorm"])
    rows_so = WORK / "rmsnorm_bwd_rows.so"
    subprocess.run(rows_kernel_command(rows_so), check=True, capture_output=True, text=True)
    entries, notes, paths = {}, [], {"rows": str(rows_so)}
    for tag, per_source in builds.items():
        so, log = per_source["rmsnorm"]
        paths[tag] = so
        lib = ctypes.CDLL(so)
        entries[tag] = {m: k.KERNELS_BWD[m].entry_in(lib) for m in ("model", "fused")}
        lines = log.splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry" in line and "rmsnorm_bwd" in line:
                notes.append(f"{tag}: {line.split(chr(39))[1]}: "
                             + " | ".join(x.strip() for x in lines[i + 2:i + 4]))
    return entries, bind_rows(rows_so), notes, paths


def blocks_for(rows, per_sm):
    """``kernels/rmsnorm.py::_bwd_blocks`` at ``per_sm`` blocks an SM (the
    kernel takes at most as many as the card holds at once with dw)."""
    strides = -(-rows // (per_sm * k._sm_count(torch.cuda.current_device())))
    return -(-rows // strides)


def launch_new(fn, x, w, r, dy, want_dw, per_sm):
    """One build's kernel at ``per_sm`` blocks an SM -> (dx, dw or None)."""
    rows, E = x.shape
    blocks = blocks_for(rows, per_sm)
    dx = torch.empty_like(x)
    dw = part = None
    if want_dw:
        dw = torch.empty((E,), dtype=torch.float32, device=x.device)
        part = torch.empty((blocks, E), dtype=torch.float32, device=x.device)
    rc = fn(x.data_ptr(), w.data_ptr(), r.data_ptr(), dy.data_ptr(), dx.data_ptr(),
            *[None if t is None else t.data_ptr() for t in (part, dw)],
            rows, E, blocks, k.DTYPES[x.dtype], stream())
    if rc:
        raise RuntimeError(f"rmsnorm_bwd failed: cudaError {rc}")
    return dx, dw


def launch_rows(fn, x, w, r, dy, want_dw):
    """The row-group kernel's ``fn`` (of ``bind_rows``) on CUDA rows -> (dx,
    its dw partials summed by torch.sum, or None): the route it took."""
    rows, E = x.shape
    rpb = ROWS_PER_BLOCK if want_dw else 1
    dx = torch.empty_like(x)
    part = (torch.empty((-(-rows // rpb), E), dtype=torch.float32, device=x.device)
            if want_dw else None)
    rc = fn(x.data_ptr(), w.data_ptr(), r.data_ptr(), dy.data_ptr(), dx.data_ptr(),
            None if part is None else part.data_ptr(), rows, E, rpb, k.DTYPES[x.dtype], stream())
    if rc:
        raise RuntimeError(f"the row-group backward failed: cudaError {rc}")
    return dx, None if part is None else part.sum(0)


def inputs(rows, E, dtype, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn((rows, E), generator=g, device="cuda") * 2).to(dtype)
    w = (torch.randn((E,), generator=g, device="cuda") * 0.1 + 1).to(dtype)
    dy = torch.randn((rows, E), generator=g, device="cuda").to(dtype)
    return x, w, dy


def ulps(a, b):
    """Largest |a - b| in bf16 ulps of the larger of the two."""
    a, b = a.float(), b.float()
    m = torch.maximum(a.abs(), b.abs()).clamp_min(2.0**-126)
    return ((a - b).abs() / torch.exp2(torch.floor(torch.log2(m)) - 7)).max().item()


def check(entries, rows_entries):
    """Each build against the row-group kernel and the plain version ->
    {build: {"cases", "dx_apart" (cases with dx not bit-equal: their
    differing elements, largest ulps), "failures"}}."""
    out = {tag: {"cases": 0, "dx_apart": [], "failures": []} for tag in entries}
    for E in (64, 4096, 8192):
        for rows in (1, 7, 133, 2560, 4099):
            for dtype in (torch.bfloat16, torch.float32):
                x, w, dy = inputs(rows, E, dtype, seed=rows + E)
                for mode in ("model", "fused"):
                    r = k._launch_fwd(x, w, EPS, mode, True)[1]
                    ins = (x, w, dy) if mode == "model" else (x.float(), w.float(), dy.float())
                    dw_p = k.rms_norm_bwd_reference(ins[0], ins[1], r, ins[2], mode)[1]
                    u = (x.float() * r[:, None]).to(dtype).float() if mode == "model" \
                        else x.float() * r[:, None]
                    terms = (dy.float().abs() * u.abs()).sum(0)
                    for want_dw in (False, True):
                        dx_old = launch_rows(rows_entries[mode], x, w, r, dy, want_dw)[0]
                        for tag, fns in entries.items():
                            res = out[tag]
                            runs = [launch_new(fns[mode], x, w, r, dy, want_dw, 2) for _ in range(2)]
                            torch.cuda.synchronize()
                            what = f"rows={rows} E={E} {str(dtype)[6:]} {mode} dw {want_dw}"
                            res["cases"] += 1
                            if not torch.equal(runs[0][0], runs[1][0]):
                                res["failures"].append(f"dx differs between two runs: {what}")
                            apart = int((runs[0][0] != dx_old).sum())
                            if apart:
                                res["dx_apart"].append(
                                    f"{what}: {apart} of {dx_old.numel()}, "
                                    f"{ulps(runs[0][0], dx_old):.2f} ulp")
                            if want_dw:
                                if not torch.equal(runs[0][1], runs[1][1]):
                                    res["failures"].append(f"dw differs between two runs: {what}")
                                err = ((runs[0][1] - dw_p).abs() / terms).max().item()
                                if err > 1e-5:
                                    res["failures"].append(f"dw off by {err:.3e}: {what}")
                del x, w, dy
    return out


def events_ms(fn, iters=50):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_us(fn, n=20):
    """Device us a call: the trace's kernel time over the calls it holds."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    kern = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us, c = kern.get(e.name, (0.0, 0))
            kern[e.name] = (us + e.time_range.elapsed_us(), c + 1)
    if not kern:
        return None, {}
    calls = min(c for _, c in kern.values())
    return sum(us / c * round(c / calls) for us, c in kern.values()), \
        {name[:60]: round(c / calls) for name, (_, c) in kern.items()}


def host_us(fn, iters=200):
    """Host us to enqueue a call (the device lags behind)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / iters * 1e6


def sass(paths):
    tool = shutil.which("cuobjdump") or str(Path(_build.nvcc_path()).with_name("cuobjdump"))
    WORK.mkdir(parents=True, exist_ok=True)
    for tag, so, want in (("new", paths["as built"], "rmsnorm_bwdI13__nv_bfloat16Lb1ELi2ELb0E"),
                          ("rows", paths["rows"], "rmsnorm_bwdI13__nv_bfloat16Lb1EE")):
        text = subprocess.run([tool, "-sass", so], capture_output=True, text=True, check=True).stdout
        chunks = [c for c in text.split("Function : ")[1:] if want in c.partition("\n")[0]]
        (WORK / f"sass_{tag}.txt").write_text("\n".join(chunks))


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("norm_bwd_probe needs an NVIDIA GPU")
    entries, rows_entries, notes, paths = build()
    for n in notes:
        print(f"[norm_bwd_probe] nvcc: {n}", flush=True)
    sass(paths)
    checks = check(entries, rows_entries)
    out = {"device": torch.cuda.get_device_name(0), "checks": checks, "rows": []}
    for tag, res in checks.items():
        print(f"[norm_bwd_probe] {tag}: {res['cases']} cases, failures {res['failures']}; dx not "
              f"bit-equal to the row-group kernel in {len(res['dx_apart'])}: {res['dx_apart']}",
              flush=True)
    E = 4096
    for rows in (2560, 4096):
        copies = [inputs(rows, E, torch.bfloat16, seed=s) for s in range(3)]
        rs = {mode: [k._launch_fwd(x, w, EPS, mode, True)[1] for x, w, _ in copies]
              for mode in ("model", "fused")}
        for mode, want_dw in (("model", False), ("model", True), ("fused", True)):
            nbytes = 2 * 3 * rows * E + 2 * E + 4 * rows + (4 * E if want_dw else 0)
            entry = {"rows": rows, "E": E, "mode": mode, "dw": want_dw,
                     "bound_ms": nbytes / PEAK_BYTES_S * 1e3}

            def walk(fn):
                """[device us, warm ms, cold ms] of ``fn(x, w, r, dy)``."""
                x, w, dy = copies[0]
                r = rs[mode][0]
                dev, kinds = device_us(lambda: fn(x, w, r, dy))
                state = {"i": 0}

                def cold():
                    i = state["i"] = (state["i"] + 1) % len(copies)
                    cx, cw, cdy = copies[i]
                    fn(cx, cw, rs[mode][i], cdy)
                return [dev, events_ms(lambda: fn(x, w, r, dy)), events_ms(cold, iters=48)], kinds

            for tag, fns in entries.items():
                for per_sm in (1, 2, 3, 4):
                    entry[f"{tag} {per_sm}/SM"] = walk(
                        lambda x, w, r, dy, f=fns[mode], p=per_sm: launch_new(
                            f, x, w, r, dy, want_dw, p))[0]
            entry["wrapper"], entry["wrapper_kernels"] = walk(
                lambda x, w, r, dy: k._bwd(x, w, r, dy, mode, want_dw))
            x, w, dy = copies[0]
            entry["wrapper_host_us"] = host_us(lambda: k._bwd(x, w, rs[mode][0], dy, mode, want_dw))
            entry["was"] = walk(lambda x, w, r, dy: launch_rows(rows_entries[mode], x, w, r, dy,
                                                                want_dw))[0]
            xg = x.detach().requires_grad_(True)
            wg = w.detach().requires_grad_(want_dw)
            y = F.rms_norm(xg, (E,), wg, EPS)
            grads = (xg, wg) if want_dw else (xg,)
            entry["library"] = walk(
                lambda *_: torch.autograd.grad(y, grads, dy, retain_graph=True))[0]
            del xg, wg, y
            out["rows"].append(entry)
            print("[norm_bwd_probe] " + json.dumps(entry), flush=True)
        del copies, rs
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    out["smi"] = smi
    print(smi, flush=True)
    print(json.dumps(out), flush=True)
    return 1 if any(res["failures"] for res in checks.values()) else 0


if __name__ == "__main__":
    raise SystemExit(main())
