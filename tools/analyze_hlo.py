#!/usr/bin/env python
"""Offline analysis of optimized-HLO dumps (tools/dump_hlo.py output):
per-fusion op/byte census and a two-dump diff (which fusions duplicate
the record gather, what a toggle changes in the schedule).

Pure text processing; no JAX.

Usage:
  python tools/analyze_hlo.py out/r5/hlo3.txt
  python tools/analyze_hlo.py out/r5/hlo5_hiz1.txt --diff out/r5/hlo5_hiz0.txt
  python tools/analyze_hlo.py out/r5/hlo3.txt --op gather --min-mb 5
"""
import argparse
import re
from collections import defaultdict

SHAPE_RE = re.compile(r"(bf16|f32|s32|u32|pred|u8|s8|f16|u16|s16)"
                      r"\[([\d,]*)\]")
DTYPE_BYTES = {"bf16": 2, "f32": 4, "s32": 4, "u32": 4, "pred": 1,
               "u8": 1, "s8": 1, "f16": 2, "u16": 2, "s16": 2}


def shape_bytes(m):
    dt, dims = m.group(1), m.group(2)
    n = 1
    for d in dims.split(","):
        if d:
            n *= int(d)
    return n * DTYPE_BYTES[dt]


def parse(path):
    """-> list of (computation_name, kind, body_lines)."""
    comps = []
    cur = None
    with open(path) as f:
        for line in f:
            m = re.match(r"(%?[\w\.\-]+)\s*(\([^)]*\).*)?{\s*$", line.strip())
            if m and ("fused_computation" in line or "ENTRY" in line
                      or line.strip().startswith("%")):
                cur = (m.group(1), [])
                comps.append(cur)
            elif cur is not None:
                cur[1].append(line.rstrip())
    return comps


def census(path, opname=None, min_mb=0.0, top=25):
    ops = defaultdict(int)
    gathers = []          # (out_bytes, line)
    fusion_lines = []
    with open(path) as f:
        for line in f:
            ls = line.strip()
            m = re.match(r"%?[\w\.\-]+\s*=\s*\S+\s+(\w+)\(", ls)
            mm = re.search(r"=\s*(?:\([^)]*\)|\S+)\s+([a-z][\w\-]*)\(", ls)
            name = mm.group(1) if mm else (m.group(1) if m else None)
            if not name:
                continue
            ops[name] += 1
            if name == "gather":
                sm = SHAPE_RE.search(ls)
                if sm:
                    gathers.append((shape_bytes(sm), ls[:160]))
            if name == "fusion":
                sm = SHAPE_RE.search(ls)
                b = shape_bytes(sm) if sm else 0
                fusion_lines.append((b, ls[:200]))

    print(f"== {path} ==")
    total = sum(ops.values())
    print(f"{total} ops; top kinds:")
    for k, v in sorted(ops.items(), key=lambda kv: -kv[1])[:top]:
        print(f"  {k:28s} {v}")
    print(f"\n{len(gathers)} gather ops; largest by output bytes:")
    for b, ls in sorted(gathers, reverse=True)[:top]:
        if b / 1e6 >= min_mb:
            print(f"  {b/1e6:9.1f} MB  {ls}")
    if opname:
        print(f"\nall '{opname}' lines >= {min_mb} MB:")
        with open(path) as f:
            for line in f:
                if f" {opname}(" in line:
                    sm = SHAPE_RE.search(line)
                    if sm and shape_bytes(sm) / 1e6 >= min_mb:
                        print("  " + line.strip()[:240])
    return ops


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("path")
    ap.add_argument("--diff", default="")
    ap.add_argument("--op", default="")
    ap.add_argument("--min-mb", type=float, default=0.0)
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args()
    a = census(args.path, args.op or None, args.min_mb, args.top)
    if args.diff:
        b = census(args.diff, args.op or None, args.min_mb, args.top)
        print(f"\n== op-count diff ({args.path} minus {args.diff}) ==")
        keys = sorted(set(a) | set(b),
                      key=lambda k: -(abs(a.get(k, 0) - b.get(k, 0))))
        for k in keys:
            d = a.get(k, 0) - b.get(k, 0)
            if d:
                print(f"  {k:28s} {a.get(k, 0):6d} vs {b.get(k, 0):6d} "
                      f"({d:+d})")


if __name__ == "__main__":
    main()
