"""The dry-run / roofline table from the port's dry-run records (the
counterpart of ``repro.roofline.report``), one row per record of
``build/dryrun_torch/`` on the H100's constants.

  python -m repro_torch.roofline.report [--dir build/dryrun_torch]
      [--tag NAME] [--mesh 16x16|2x16x16|1x1|all]
"""

from __future__ import annotations

import argparse
import glob
import json
import os

from ..configs import all_cells

COLS = ["arch", "shape", "mesh", "policy", "dom", "t_comp", "t_mem",
        "t_coll", "frac", "useful", "temp_GiB", "args_GiB", "colls"]

DEFAULT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "build", "dryrun_torch")


def load_records(d: str, tag: str = ""):
    """(arch, shape, mesh) -> record; untagged files only, or those of
    ``tag`` (the naming contract of ``artifacts/dryrun/README.md``)."""
    out = {}
    for f in glob.glob(os.path.join(d, "*.json")):
        parts = os.path.basename(f)[:-5].split("__")
        if tag and (len(parts) < 4 or parts[3] != tag):
            continue
        if not tag and len(parts) > 3:
            continue
        with open(f) as fh:
            r = json.load(fh)
        out[(r["arch"], r["shape"], tuple(r["mesh"]))] = r
    return out


def fmt_row(r) -> str:
    rf = r["roofline"]
    m = r["memory"]
    return ("| {arch} | {shape} | {mesh} | {policy} | {dom} | "
            "{tc:.4f} | {tm:.4f} | {tk:.4f} | {fr:.3f} | {uf:.2f} | "
            "{tmp:.1f} | {arg:.1f} | {nc:d} |").format(
        arch=r["arch"], shape=r["shape"],
        mesh="x".join(map(str, r["mesh"])), policy=r["policy"],
        dom=rf["dominant"], tc=rf["t_compute_s"], tm=rf["t_memory_s"],
        tk=rf["t_collective_s"], fr=rf["roofline_fraction"],
        uf=rf["useful_flops_ratio"],
        tmp=m["temp_bytes"] / 2**30, arg=m["argument_bytes"] / 2**30,
        nc=int(r["collectives"]["count"]))


HEADER = ("| arch | shape | mesh | policy | dominant | t_compute(s) | "
          "t_memory(s) | t_coll(s) | roofline_frac | useful_flops | "
          "temp GiB/rank | args GiB/rank | #coll |\n"
          "|---|---|---|---|---|---|---|---|---|---|---|---|---|")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=DEFAULT_DIR)
    ap.add_argument("--tag", default="")
    ap.add_argument("--mesh", default="16x16",
                    help="16x16 (single pod) | 2x16x16 (multi-pod) | 1x1 "
                         "| all")
    args = ap.parse_args(argv)
    recs = load_records(args.dir, args.tag)
    if args.mesh != "all":
        want = tuple(int(x) for x in args.mesh.split("x"))
        recs = {k: v for k, v in recs.items() if k[2] == want}
    print(HEADER)
    done, skipped, missing = 0, 0, []
    for arch, sname, cfg, shp, runnable in all_cells():
        if not runnable:
            print(f"| {arch} | {sname} | - | - | SKIP (long_500k needs "
                  f"sub-quadratic attention) | | | | | | | | |")
            skipped += 1
            continue
        hit = [r for (a, s, m), r in recs.items()
               if a == arch and s == sname]
        if not hit:
            missing.append((arch, sname))
            continue
        for r in sorted(hit, key=lambda r: r["mesh"]):
            print(fmt_row(r))
            done += 1
    print(f"\ncells: {done} baselined, {skipped} documented skips, "
          f"{len(missing)} missing {missing if missing else ''}")


if __name__ == "__main__":
    main()
