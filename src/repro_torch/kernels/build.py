"""Build a hand-written CUDA source of ``csrc/`` into a shared library.

Every kernel of the port is a ``csrc/<name>.cu`` file with a plain C
interface, compiled with ``nvcc`` for ``sm_90a`` into
``build/torch_kernels/lib<name>.so`` (``build/`` is listed in
.gitignore) and bound with ``ctypes`` by its wrapper. ``build(name)``
compiles when the library is missing or older than its source or a
shared header of ``csrc/`` (``*.cuh``), so the first call of a wrapper
on the card builds it and later calls reuse it.
"""
from __future__ import annotations

import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Tuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
#: build outputs live in the checkout's ``build/`` (listed in .gitignore)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
#: grid cap for the kernels' grid-stride loops (132 SMs x 8 resident
#: blocks of 256 threads)
MAX_GRID = 132 * 8


def source(name: str) -> Path:
    return CSRC / f"{name}.cu"


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the port's CUDA kernels are "
                           "built from source on the CUDA host")
    return found


def build(name: str, force: bool = False) -> Tuple[Path, float]:
    """Compile ``csrc/<name>.cu`` if its library is missing or older than
    the source or a header. Returns (library path, seconds spent compiling)."""
    src = source(name)
    lib = BUILD_DIR / f"lib{name}.so"
    newest = max(p.stat().st_mtime for p in (src, *CSRC.glob("*.cuh")))
    if not force and lib.exists() and lib.stat().st_mtime >= newest:
        return lib, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib, time.perf_counter() - t0


def resource_usage(name: str) -> Tuple[Dict[str, dict], list]:
    """Compile ``csrc/<name>.cu`` to a cubin with ``-Xptxas -v`` and read
    what ptxas says of each kernel: {mangled name: {registers,
    spill_stores, spill_loads, stack_bytes}}, and ptxas's warnings and
    notes."""
    fd, cubin = tempfile.mkstemp(suffix=".cubin")
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS[:4], "-cubin", "-Xptxas", "-v",
             "-o", cubin, str(source(name))], capture_output=True, text=True)
    finally:
        os.unlink(cubin)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc -Xptxas -v failed for {name}:\n"
                           f"{proc.stderr}")
    usage: Dict[str, dict] = {}
    cur = None
    for line in proc.stderr.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w$]+)'?", line)
        if m:
            cur = usage.setdefault(m.group(1), {})
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and cur is not None:
            cur.update(stack_bytes=int(m.group(1)),
                       spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
    # warnings, and ptxas's notes on wgmma and setmaxnreg (C75xx)
    warnings = [ln.strip() for ln in proc.stderr.splitlines()
                if "warning" in ln.lower() or "(C75" in ln]
    return usage, warnings


#: one folded counter-hash draw collected into a word as kv_quant.cu
#: collects it (``counter_hash.cuh``: the ^ of the folded index and
#: plane, draw_key, collect), alone in a kernel so that its instructions
#: can be counted. The thread indices stand in for the folded index and
#: the word collected so far, so the draw runs per thread (not on the
#: uniform datapath) and needs no address arithmetic.
_DRAW_PROBE = r"""
#include "counter_hash.cuh"
extern "C" __global__ void one_draw(unsigned key, unsigned thr_hi,
                                    unsigned thr, unsigned* out) {
  *out = counter_hash::collect(
      threadIdx.y, counter_hash::draw_key(threadIdx.x ^ key, thr_hi), thr);
}
"""
#: SASS opcodes of integer work (register moves, IMAD.MOV, are not)
_INT_OPS = ("LOP3", "IMAD", "SHF", "ISETP", "IADD3", "VIADD", "LEA", "SEL",
            "PRMT")


def draw_ops() -> Dict[str, object]:
    """Integer instructions of one counter-hash draw whose outcome is
    collected: the SASS (``nvcc -cubin``, then ``cuobjdump -sass``) of a
    kernel that makes one folded draw and collects it, counted by opcode
    and by the pipe each issues to (``pipe``). Returns {"alu": n,
    "fma": n, "total": n, "ops": listing of the counted instructions}."""
    with tempfile.TemporaryDirectory() as tmp:
        src, cubin = Path(tmp) / "one_draw.cu", Path(tmp) / "one_draw.cubin"
        src.write_text(_DRAW_PROBE)
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS[:4], "-cubin", "-I", str(CSRC), "-o",
             str(cubin), str(src)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the draw probe:\n"
                               f"{proc.stderr}")
        sass = subprocess.run(
            [str(Path(_nvcc()).parent / "cuobjdump"), "-sass", str(cubin)],
            capture_output=True, text=True, check=True).stdout
    counted = int_ops(sass)
    pipes = [pipe(op) for op in counted]
    return {"alu": pipes.count("alu"), "fma": pipes.count("fma"),
            "total": len(counted), "ops": " ".join(counted)}


def int_ops(sass: str) -> list:
    """The integer instructions (opcode with modifiers) of a
    ``cuobjdump -sass`` listing, in order."""
    ops = [m.group(1) for m in re.finditer(
        r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)", sass)]
    return [op for op in ops if op.split(".")[0] in _INT_OPS
            and not op.startswith("IMAD.MOV")]


def pipe(op: str) -> str:
    """The pipe an integer instruction issues to on Hopper: the integer
    multiply-adds (IMAD and its forms: IMAD.X, IMAD.HI, IMAD.WIDE) to the
    FMA pipe, the rest (LOP3, SHF, IADD3, ISETP, SEL, LEA, PRMT, VIADD) to
    the integer ALU."""
    return "fma" if op.split(".")[0] == "IMAD" else "alu"
