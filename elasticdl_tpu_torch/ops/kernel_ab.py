"""A/B of source variants of the flash-attention kernels, in one process
on one card (two calls may land on two cards, so versions are compared
inside one):

    python3 -m elasticdl_tpu_torch.ops.kernel_ab

Builds flash_fwd.cu, flash_dq.cu and flash_dkv.cu from ops/csrc/ ("cur")
and from copies with text substitutions (VARIANTS), each into its own
library under build/kernel_ab/, and calls them through the same C entry
points. A variant builds only the kernels whose source or headers it
changes. For each case it prints one JSON line per variant: kernel ms
(CUDA events, in the order cur, variant, variant, cur), max abs error
against the plain versions, whether each output is bitwise equal to
cur's, and the registers and spill bytes ptxas reports for each
instantiation. The variant "no_exact" turns off the skipping of zero
small parts, so on TF32-exact inputs it shows what that path saves and
that it changes no bit; "cvt_rna" rounds to TF32 with the PTX
instruction in place of the integer operations that give the same bits.
The "fwd_" variants change the forward kernel: 32-row K, V tiles in
place of 64 ("fwd_k32"); P V partials over 8 output tiles at D = 128 in
place of 4 ("fwd_group8"); and blocks ordered q-tile-fastest, so each
head's q tiles go heaviest first but the heads one after another
("fwd_q_major"). Needs a CUDA device and nvcc, like the kernels.
"""

import ctypes
import json
import os
import re
import shutil
import subprocess

import torch

from elasticdl_tpu_torch.ops import _build
from elasticdl_tpu_torch.ops import flash_attention as fa

OUT = os.path.join(os.path.dirname(_build.BUILD_DIR), "kernel_ab")
NAMES = ("flash_fwd", "flash_dq", "flash_dkv")
_FWD = "flash_fwd.cu"
# variant -> [(file in csrc, old text, new text)]
VARIANTS = {
    "no_exact": [("flash_mma.cuh", "return (bits & 0x1fffu) == 0;",
                  "return false;")],
    "cvt_rna": [("flash_mma.cuh",
                 "  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;",
                 "  uint32_t r;\n"
                 "  asm(\"cvt.rna.tf32.f32 %0, %1;\\n\" : \"=r\"(r) : \"f\"(x));\n"
                 "  return r;")],
    "fwd_k32": [(_FWD, "kRowsK = 64;", "kRowsK = 32;")],
    "fwd_group8": [(_FWD, "kGroup = 4;", "kGroup = D == 128 ? 8 : 4;")],
    "fwd_q_major": [
        (_FWD, "q_tile = blockIdx.y, bh = blockIdx.x",
         "q_tile = blockIdx.x, bh = blockIdx.y"),
        (_FWD, "grid(bh, (s + Tiles::kRowsQ - 1) / Tiles::kRowsQ)",
         "grid((s + Tiles::kRowsQ - 1) / Tiles::kRowsQ, bh)")],
}
# (shape, causal, inputs rounded to bfloat16 in f32 tensors)
CASES = [
    ((4, 8, 4096, 128), True, False),
    ((4, 8, 4096, 128), True, True),
    ((4, 8, 4096, 64), True, True),
]


def _changes(name, subs):
    """Whether substitutions `subs` change kernel `name`'s build."""
    return any(f == f"{name}.cu" or f.endswith(".cuh") for f, _, _ in subs)


def _build_variants(variants, names=NAMES):
    """{(variant, kernel name): (C entry point, ptxas report)}, all built
    in parallel; a variant builds only the kernels it changes."""
    shutil.rmtree(OUT, ignore_errors=True)
    procs = []
    for variant, subs in {"cur": [], **variants}.items():
        src = os.path.join(OUT, variant)
        shutil.copytree(_build.CSRC, src)
        for fname, old, new in subs:
            path = os.path.join(src, fname)
            with open(path) as f:
                text = f.read()
            if old not in text:
                raise ValueError(f"{variant}: {old!r} not in {fname}")
            with open(path, "w") as f:
                f.write(text.replace(old, new))
        for name in names:
            if variant != "cur" and not _changes(name, subs):
                continue
            lib = os.path.join(src, f"{name}.so")
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib,
                   os.path.join(src, f"{name}.cu")]
            procs.append((variant, name, lib, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    fns = {}
    for variant, name, lib, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {variant}/{name}:\n{log}")
        entry, argtypes = _build.KERNELS[name]
        fn = getattr(ctypes.CDLL(lib), entry)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns[(variant, name)] = fn, ptxas_report(log)
    return fns


def ptxas_report(log):
    """{"f32/128": [registers, spill store bytes], ...} for each kernel
    instantiation in an `nvcc -Xptxas -v` log."""
    report, key, spill = {}, None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\w+?kernelI(\w+?)Li(\d+)E",
                      line)
        if m:
            key = f"{'f32' if m.group(1) == 'f' else 'bf16'}/{m.group(2)}"
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and key:
            report[key] = [int(m.group(1)), spill]
    return report


def _launcher(fn, name, q, k, v, g, lse, delta, causal):
    """(launch, outputs) for one library's kernel on these inputs."""
    b, h, s, d = q.shape
    if name == "flash_fwd":
        outs = [torch.empty_like(q), torch.empty_like(lse)]
        args = [t.data_ptr() for t in (q, k, v, *outs)]
    else:
        outs = [torch.empty_like(q) for _ in range(1 if name == "flash_dq"
                                                   else 2)]
        args = [t.data_ptr() for t in (q, k, v, g, lse, delta, *outs)]
    code = fa._DTYPE_CODES[q.dtype]
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        err = fn(*args, b * h, s, d, code, int(causal), d**-0.5, stream)
        if err:
            raise RuntimeError(f"{name} launch failed ({err})")

    return launch, outs


def _ms(fn, iters=10):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main(variants=VARIANTS, cases=CASES, names=NAMES):
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    fns = _build_variants(variants, names)
    order = ["cur", *variants]
    for shape, causal, bf16_exact in cases:
        gen = torch.Generator(device="cuda").manual_seed(0)
        q, k, v, g = (torch.randn(shape, device="cuda", generator=gen)
                      for _ in range(4))
        if bf16_exact:
            q, k, v, g = (t.bfloat16().float() for t in (q, k, v, g))
        out, lse = fa._fwd_plain(q, k, v, causal)
        delta = fa._delta(g, out)
        inputs = (q, k, v, g, lse, delta, causal)
        want = {"flash_fwd": [out, lse],
                "flash_dq": [fa._dq_plain(*inputs)],
                "flash_dkv": list(fa._dkv_plain(*inputs))}
        runs = {key: _launcher(fn, key[1], *inputs)
                for key, (fn, _) in fns.items()}
        for launch, _ in runs.values():
            launch()
        torch.cuda.synchronize()
        times = {key: [] for key in runs}
        for variant in order + order[::-1]:
            for name in names:
                if (variant, name) in runs:
                    times[(variant, name)].append(
                        _ms(runs[(variant, name)][0]))
        for variant in order:
            row = {"shape": shape, "causal": causal,
                   "bf16_exact_inputs": bf16_exact, "variant": variant,
                   "device": torch.cuda.get_device_name(0)}
            for name in names:
                if (variant, name) not in runs:
                    continue
                outs = runs[(variant, name)][1]
                row[name] = {
                    "ms": sum(times[(variant, name)]) / 2,
                    "max_abs_err": max(float((a - b).abs().max())
                                       for a, b in zip(outs, want[name])),
                    "bitwise_equal_cur": all(
                        torch.equal(a, b) for a, b in
                        zip(outs, runs[("cur", name)][1])),
                    "registers_spill_bytes": fns[(variant, name)][1],
                }
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
