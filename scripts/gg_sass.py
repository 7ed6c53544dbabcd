#!/usr/bin/env python3
"""Registers, spills and tensor-core instructions of every kernel instance in
``hpc_ops_tpu_torch/csrc/group_gemm.cu``.

Usage: ``python3 scripts/gg_sass.py [OUT_DIR]`` on a machine with the CUDA
toolkit (``nvcc``, ``cuobjdump``). Compiles the source for ``sm_90a`` with
``-Xptxas -v`` (the full log goes to ``OUT_DIR/ptxas_group_gemm.txt``, the
SASS to ``OUT_DIR/sass_group_gemm.txt``; OUT_DIR defaults to the git-ignored
``build/sass``), then prints one JSON line per kernel instance: its
registers, stack and spill bytes, whether ptxas serialised its wgmmas
(advisory C7520: a wgmma on a divergent path; C7513: an instruction writes
a wgmma's register operand while wgmmas are in flight, which the
register-operand body does by design, converting the next stage's A
fragments while a stage's products run; a form without it measured no
faster on an H100), and its counts of QGMMA (fp8 wgmma), IGMMA (int8
wgmma), HGMMA, HMMA (mma.sync in 16 bits), IMMA (mma.sync in int8) and e4m3
unpacking conversions (``F2FP`` with ``E4M3``). Exits 1 if an 8-bit wgmma
instance (int8, blockwise e4m3) lacks its QGMMA (e4m3) or IGMMA (int8),
holds an e4m3 conversion or HMMA, or has C7520 or C7513; if an instance of
the register-operand body (``*_e4m3_rs_kernel``, the e4m3 per-tensor forms
from m-tiles of 64: fp16 products of e4m3 values converted in registers)
lacks HGMMA or an e4m3 conversion, holds QGMMA or HMMA, spills, or has
C7520; or if an instance of the mma.sync body (``*_mma_kernel``, the e4m3
per-tensor forms at decode m-tiles) lacks HMMA or holds QGMMA.
"""

import json
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "hpc_ops_tpu_torch", "csrc", "group_gemm.cu")
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]
OPS = {"QGMMA": r"\bQGMMA\b", "IGMMA": r"\bIGMMA\b", "HGMMA": r"\bHGMMA\b", "HMMA": r"\bHMMA\b",
       "IMMA": r"\bIMMA\b", "e4m3_cvt": r"\bF2FP\.[A-Z0-9_.]*E4M3"}


def tool(name):
    return shutil.which(name) or os.path.join("/usr/local/cuda/bin", name)


def demangle(names):
    filt = shutil.which("cu++filt") or shutil.which("c++filt") or tool("cu++filt")
    try:
        out = subprocess.run([filt], input="\n".join(names), capture_output=True, text=True,
                             check=True).stdout.splitlines()
        return dict(zip(names, out)) if len(out) == len(names) else {n: n for n in names}
    except (OSError, subprocess.CalledProcessError):
        return {n: n for n in names}


def main(out_dir: str) -> int:
    os.makedirs(out_dir, exist_ok=True)
    obj = os.path.join(out_dir, "group_gemm.o")
    build = subprocess.run([tool("nvcc"), *FLAGS, "-Xptxas", "-v", "-c", SRC, "-o", obj],
                           capture_output=True, text=True)
    log = build.stdout + build.stderr
    with open(os.path.join(out_dir, "ptxas_group_gemm.txt"), "w") as f:
        f.write(log)
    if build.returncode != 0:
        print(log[-6000:])
        return 1
    sass = subprocess.run([tool("cuobjdump"), "-sass", obj], capture_output=True, text=True,
                          check=True).stdout
    with open(os.path.join(out_dir, "sass_group_gemm.txt"), "w") as f:
        f.write(sass)

    info, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)'?", line)
        if m:
            cur = m.group(1)
            info.setdefault(cur, {})
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and cur:
            info[cur].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            info[cur]["registers"] = int(m.group(1))
    c7520 = [line for line in log.splitlines() if "C7520" in line]
    c7513 = [line for line in log.splitlines() if "C7513" in line]

    counts, cur = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = m.group(1)
            counts[cur] = {k: 0 for k in OPS}
        elif cur:
            for k, pat in OPS.items():
                if re.search(pat, line):
                    counts[cur][k] += 1

    names = sorted(set(info) | set(counts))
    pretty = demangle(names)
    bad = 0
    for name in names:
        row = {"kernel": pretty[name], **info.get(name, {}), **counts.get(name, {})}
        row["c7520"] = any(name in line for line in c7520)
        row["c7513"] = any(name in line for line in c7513)
        fp8 = "e4m3" in name
        if "_mma_kernel" in name:  # the mma.sync body: fp16 products of e4m3
            row["body"] = "mma.sync"
            row["ok"] = row.get("HMMA", 0) > 0 and row.get("QGMMA", 0) == 0
        elif "_rs_kernel" in name:  # e4m3 per-tensor: fp16 A from registers
            row["body"] = "wgmma f16, A in registers"
            row["ok"] = (row.get("HGMMA", 0) > 0 and row.get("e4m3_cvt", 0) > 0
                         and row.get("QGMMA", 0) == 0 and row.get("HMMA", 0) == 0
                         and row.get("spill_stores", 0) == 0 and not row["c7520"])
        else:
            row["body"] = "wgmma 8-bit"
            row["ok"] = (row.get("QGMMA" if fp8 else "IGMMA", 0) > 0 and row.get("e4m3_cvt", 0) == 0
                         and row.get("HMMA", 0) == 0 and not row["c7520"] and not row["c7513"])
        bad += not row["ok"]
        print(json.dumps(row))
    unattributed = [line for line in c7520 + c7513 if not any(n in line for n in names)]
    print(json.dumps({"summary": True, "instances": len(names), "failed": bad,
                      "c7520_lines": len(c7520), "c7513_lines": len(c7513),
                      "unattributed": unattributed[:4]}))
    return 1 if bad or unattributed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1 else os.path.join(ROOT, "build", "sass")))
