#!/usr/bin/env python3
"""Planted faults in K8's tensor-core route, each in a copy of the tree,
held against ``chip_smoke.py``'s two K8 checks on one GPU.

    python3 tools/k8_faults.py

For each fault the script copies ``src/`` and ``chip_smoke.py`` into a
temporary directory, applies one named text substitution to the copy's
``csrc/ssd_scan.cu`` (it fails if the text is not there exactly once),
and runs, in a child process on the copy (which builds its own kernels):
``check_ssd_scan`` at the slow decay (1, 4096, 48, 64, 128), chunk 256,
and ``check_ssd_prefill`` on layer 0's inputs of mamba2-780m at full width
over 32,768 seeded tokens. A check refuses a fault when it raises. The
unchanged copy runs first as the control, which both checks must accept.
Exits 0 when the control passes and every fault is refused by both
checks; needs a card (exits 2 without one).
"""
from __future__ import annotations

import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = "src/repro_torch/kernels/csrc/ssd_scan.cu"

# name -> (what it breaks, committed text, planted text)
FAULTS = {
    "control": ("nothing (the committed kernel)", None, None),
    "dropped_carry": (
        "the state carried into the middle chunk is dropped (pass 2)",
        "col[(c0 + k) * step] = s;",
        "col[(c0 + k) * step] = c0 + k == NC / 2 ? 0.0f : s;"),
    "wrong_cb_tile": (
        "C·Bᵀ tile (1, 0) of every chunk takes the B rows of tile 1",
        "sb = s0 + jt * T + r;",
        "sb = s0 + (tile == 1 ? 1 : jt) * T + r;"),
}

CHILD = r"""
import subprocess, sys
sys.path.insert(0, "src")
import chip_smoke as cs
import torch
from repro_torch.models import model as M
from repro_torch.models.registry import get_config
cs.CARD = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
device = torch.device("cuda", 0)
refused = []
try:
    cs.check_ssd_scan(device, (((1, 4096, 48, 64, 128), 256, 0.01),))
except AssertionError as e:
    cs.log(f"  check_ssd_scan refused: {str(e)[:160]}")
    refused.append("check_ssd_scan")
cfg = get_config("mamba2-780m")
params = M.init(cfg, seed=0, device=device)
tokens = cs.prefill_tokens(cfg, 1, cs.PREFILL_SEQ, 0, device)
inputs = cs.layer_ssd_inputs(cfg, params, tokens)
del params
try:
    cs.check_ssd_prefill(*inputs, cfg.ssm.chunk_size)
except AssertionError as e:
    cs.log(f"  check_ssd_prefill refused: {str(e)[:160]}")
    refused.append("check_ssd_prefill")
print("REFUSED", " ".join(refused) or "none", flush=True)
"""


def run(name: str) -> list:
    what, old, new = FAULTS[name]
    with tempfile.TemporaryDirectory() as tmp:
        shutil.copytree(ROOT / "src", Path(tmp) / "src",
                        ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy(ROOT / "chip_smoke.py", tmp)
        if old is not None:
            path = Path(tmp) / SOURCE
            text = path.read_text()
            if text.count(old) != 1:
                raise SystemExit(f"[{name}] the text to replace is not in "
                                 f"{SOURCE} exactly once")
            path.write_text(text.replace(old, new))
        print(f"[{name}] {what}", flush=True)
        proc = subprocess.run([sys.executable, "-c", CHILD], cwd=tmp,
                              capture_output=True, text=True, timeout=900)
    lines = proc.stdout.splitlines()
    for line in lines:
        if not line.startswith("REFUSED"):
            print(line, flush=True)
    if proc.returncode != 0 or not lines or \
            not lines[-1].startswith("REFUSED"):
        print(proc.stderr[-3000:], flush=True)
        raise SystemExit(f"[{name}] the child failed (rc "
                         f"{proc.returncode})")
    return [w for w in lines[-1].split()[1:] if w != "none"]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("k8_faults: needs a GPU", file=sys.stderr)
        return 2
    ok = True
    for name in FAULTS:
        refused = run(name)
        if name == "control":
            good = not refused
            verdict = "accepted by both checks" if good else \
                "refused by " + " ".join(refused)
            print(f"[{name}] {verdict}", flush=True)
        else:
            good = len(refused) == 2
            print(f"[{name}] refused by {len(refused)} of 2 checks "
                  f"({' '.join(refused) or 'none'})", flush=True)
        ok &= good
    print(f"k8_faults: {'ok' if ok else 'FAILED'}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
