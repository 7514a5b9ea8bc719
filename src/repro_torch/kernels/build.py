"""Build the hand-written CUDA kernels and bind them with ``ctypes``.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, at first use, into ``build/kernels``
at the root of the checkout. The library's file name carries a hash of
its source, so an edited source is rebuilt and an unchanged one reused.
All sources are compiled at once, one ``nvcc`` process each.

Nothing here runs at import: the CPU tests import every module of the
port on a machine without ``nvcc`` or a card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
SOURCES = ("fake_quant", "mlp3", "polyak", "adam_polyak", "quant_matmul",
           "flash_attention", "ssd_scan", "rglru_scan")

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "fake_quant": {"fake_quant_launch": [_P, _P, _P, ctypes.c_longlong]
                   + [_I] * 9 + [_P],
                   "fake_quant_slots_launch":
                   [_P, _P, _P, ctypes.c_longlong, ctypes.c_longlong]
                   + [_I] * 3 + [ctypes.POINTER(ctypes.c_int)] + [_I] * 6
                   + [_P],
                   "fake_quant_slots_dev_launch":
                   [_P, _P, _P, ctypes.c_longlong, ctypes.c_longlong]
                   + [_I] * 3 + [_P] + [_I] * 6 + [_P]},
    "mlp3": {"mlp3_launch": [_P] * 10 + [_I] * 8 + [_P],
             "mlp3_members_launch": [_P] * 10 + [_I] * 9 + [_P]},
    "adam_polyak": {"adam_polyak_launch":
                    [ctypes.POINTER(ctypes.c_longlong)] * 6 + [_I, _I, _P]
                    + [ctypes.c_float] * 8 + [_P]},
    "polyak": {"polyak_launch":
               [ctypes.POINTER(ctypes.c_longlong)] * 4
               + [_I, ctypes.c_float, ctypes.c_float, _P]},
    "quant_matmul": {"quant_matmul_int8_launch": [_P] * 7 + [_I] * 4 + [_P],
                     "quant_matmul_int4_launch": [_P] * 7 + [_I] * 4 + [_P],
                     "quant_matmul_tc_launch": [_P] * 7 + [_I] * 7 + [_P]},
    "flash_attention": {"flash_attention_launch":
                        [_P] * 4 + [ctypes.POINTER(ctypes.c_longlong)]
                        + [_I] * 6 + [ctypes.c_float, _I, _I, _P],
                        "flash_attention_tc_launch":
                        [_P] * 4 + [ctypes.POINTER(ctypes.c_longlong)]
                        + [_I] * 5 + [ctypes.c_float, _I, _I, _P]},
    "ssd_scan": {"ssd_scan_launch":
                 [_P] * 4 + [ctypes.POINTER(ctypes.c_longlong)] + [_P] * 5
                 + [_I] * 6 + [_P],
                 "ssd_scan_tc_launch":
                 [_P] * 4 + [ctypes.POINTER(ctypes.c_longlong)] + [_P] * 6
                 + [_I] * 6 + [_P]},
    "rglru_scan": {"rglru_scan_launch": [_P] * 6 + [_I] * 5
                   + [ctypes.c_uint, _I, _P]},
}

# Kernel launches per wrapper, counted where each wrapper launches its
# kernel (never for the plain version on a CPU tensor).
# "flash_attention" counts every K6 launch, "flash_attention_tc" those of
# its tensor-core route; "ssd_scan" and "ssd_scan_tc" likewise for K8;
# "quant_matmul_int8" / "_int4" count every K4 / K5 launch and
# "quant_matmul_tc" those of either on its tensor-core route.
# "polyak" counts K3 launches, each over all the leaves it is given.
# "mlp3_members" counts K2's member form (P networks a launch), apart from
# "mlp3"; "adam_polyak" the fused Adam + Polyak pass (one network's
# stacked leaves a launch).
# "fake_quant_slots" counts K1's launches over K policy slots, apart from
# "fake_quant" (one tensor).
LAUNCHES = {"fake_quant": 0, "fake_quant_slots": 0,
            "fake_quant_slots_dev": 0, "mlp3": 0, "mlp3_members": 0,
            "polyak": 0, "adam_polyak": 0,
            "quant_matmul_int8": 0, "quant_matmul_int4": 0,
            "quant_matmul_tc": 0, "flash_attention": 0,
            "flash_attention_tc": 0, "ssd_scan": 0, "ssd_scan_tc": 0,
            "rglru_scan": 0}

_libs: dict = {}
build_report: dict = {}     # name -> {"seconds", "ptxas"} of the last build


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    return str(path) if path.exists() else "nvcc"


def _lib_path(name: str) -> Path:
    digest = hashlib.sha1((CSRC / f"{name}.cu").read_bytes()
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{name}.{digest}.so"


def build_all() -> dict:
    """Compile every source whose library is missing, all in parallel.
    Returns ``build_report``; raises with nvcc's output if one fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in SOURCES:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu ---\n{log}")
            continue
        os.replace(tmp, out)
        build_report[name] = {"seconds": time.perf_counter() - t0,
                              "ptxas": _ptxas_summary(log)}
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return build_report


def _ptxas_summary(log: str) -> list:
    """Registers, shared memory and spills per kernel from -Xptxas -v.
    ptxas prints a function's spills under "Function properties for
    <name>", before its "Used N registers" line, so they are matched by
    name."""
    rows, kernel, props, spills = [], None, None, {}
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            kernel = m.group(1)
        m = re.search(r"Function properties for (\w+)", line)
        if m:
            props = m.group(1)
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and props:
            spills[props] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and kernel:
            smem = re.search(r"(\d+) bytes smem", line)
            rows.append({"kernel": kernel, "registers": int(m.group(1)),
                         "smem_bytes": int(smem.group(1)) if smem else 0})
    for row in rows:
        row["spill_store_bytes"] = spills.get(row["kernel"], 0)
    return rows


def lib(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    if name not in _libs:
        path = _lib_path(name)
        if not path.exists():
            build_all()
        handle = ctypes.CDLL(str(path))
        for fn, argtypes in _SIGNATURES[name].items():
            getattr(handle, fn).argtypes = argtypes
            getattr(handle, fn).restype = ctypes.c_int
        _libs[name] = handle
    return _libs[name]


def check_operand(t: torch.Tensor, name: str, ndim: int,
                  dtype: torch.dtype = torch.float32,
                  contiguous: bool = True) -> None:
    """What every hand-written kernel takes: a tensor of ``dtype`` on
    cuda:0, contiguous unless the kernel reads element strides."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: kernels take CUDA tensors, "
                         f"got {t.device}")
    if t.device.index not in (None, 0):
        raise ValueError(f"{name}: kernels run on cuda:0, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim}-D, got {tuple(t.shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
