#!/usr/bin/env python3
"""K1-K8 of several checkouts on one card, in turns.

    python3 chip_compare.py ROOT [ROOT ...] [--json PATH]

Each ROOT is a checkout of this repository (the working tree, or a parent
commit unpacked with ``git archive`` into a directory that .gitignore
lists).  For each, in the order given and in a process of its own, the
script builds that checkout's kernels (into its own ``build/kernels``),
prints ptxas' register and spill lines, and runs that checkout's
``chip_smoke.kernel_phase`` and ``bwd_kernel_phase`` (which also hold
every kernel against its plain version).  It prints each kernel's time as
chip_smoke.py's kernel table counts it (float32 and bfloat16: K1-K4 per
batch-8 forward, K5-K8 per batch-32 training step, in a CUDA graph with
the L2 cache warm) with the card's name and power limit.  Give the roots
as parent, change, change, parent to see the spread beside the
difference.  Needs a CUDA card and ``nvcc``, like chip_smoke.py.
"""
import argparse
import importlib.util
import json
import os
import re
import subprocess
import sys

KERNELS = ("fu_mm_fwd", "fu_mm_skip_fwd", "fu_c3_fwd2d", "fu_c3_fwd4d",
           "fu_mm_bwd", "fu_c3_bwd2d", "fu_c3_bwd4d", "nn_conv1x1_bwd")


def ptxas_functions(log):
    """[[function, registers, spill store bytes]] from ``nvcc -Xptxas -v``'s
    output, the names demangled by c++filt where it is installed."""
    funcs, name, spill = [], None, 0
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name, spill = m.group(1), 0
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            funcs.append([name, int(m.group(1)), spill])
            name = None
    try:
        out = subprocess.run(["c++filt"], input="\n".join(
            f[0] for f in funcs), capture_output=True, text=True,
            check=True).stdout.splitlines()
        if len(out) == len(funcs):
            for f, d in zip(funcs, out):
                f[0] = d
    except (OSError, subprocess.CalledProcessError):
        pass
    return funcs


def one_root(root, build_only=False):
    """Build and (unless ``build_only``) time the kernels of checkout
    ``root`` in this process: {"ptxas": [[library, function, registers,
    spill bytes]], "card": ..., "ms": {dtype: {kernel: ms}}}."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from mxnet_tpu_torch import cuda_build
    from mxnet_tpu_torch.ops import fused_unit as fu
    from mxnet_tpu_torch.ops import nn
    cuda_build.build()
    ptxas = []
    for name, (_, out) in sorted(cuda_build.build_log.items()):
        ptxas += [[name] + f for f in ptxas_functions(out)]
    if build_only:
        return {"root": root, "card": cs.card_line(), "ptxas": ptxas,
                "ms": {}}
    dev = torch.device("cuda", 0)
    rows = cs.kernel_phase(torch, fu, dev, 0)
    bwd = cs.bwd_kernel_phase(torch, fu, nn, dev, 0)
    ms = {}
    for dname in ("float32", "bfloat16"):
        ms[dname] = {}
        for k in KERNELS:
            sel = [r for r in rows if r["kernel"] == k and not r["variant"]
                   and r["dtype"] == dname]
            weight = "units_per_forward"
            if not sel:
                sel = [r for r in bwd if r["kernel"] == k
                       and r["dtype"] == dname]
                weight = "units_per_step"
            ms[dname][k] = sum(r["ms"] * r[weight] for r in sel)
    return {"root": root, "card": cs.card_line(), "ptxas": ptxas, "ms": ms}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--json", metavar="PATH")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    ap.add_argument("--build-only", action="store_true",
                    help="print the registers and spills, time nothing")
    opts = ap.parse_args()
    if opts.one:
        print(json.dumps(one_root(opts.one, opts.build_only)))
        return
    results = []
    for root in opts.roots:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one", root, root]
            + (["--build-only"] if opts.build_only else []),
            capture_output=True, text=True)
        if proc.returncode:
            sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
            sys.exit("chip_compare: %s failed" % root)
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        results.append(res)
        print("%s [%s]" % (root, res["card"]), flush=True)
        for lib, func, regs, spill in res["ptxas"]:
            print("  %-16s %3d registers %4d bytes spilled  %s"
                  % (lib, regs, spill, func[:150]))
        for dname, per in res["ms"].items():
            print("  %-8s %s" % (dname, "  ".join(
                "%s %.4f" % (k, v) for k, v in per.items())), flush=True)
    if opts.json:
        with open(opts.json, "w") as f:
            json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
