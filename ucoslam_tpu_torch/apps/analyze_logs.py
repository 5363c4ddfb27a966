"""Aggregate benchmark results + paired significance tests.

Counterpart of tests/analyzeAllLogs.cpp (aggregate result directories) and
tests/wilcoxonTests.cpp (paired Wilcoxon signed-rank between two methods).

Layout expected: <root>/<method>/<sequence>/trajectory.txt + groundtruth.txt
(as produced by ucoslam_tpu_torch.apps.test_sequence with --out-dir <root>/<method>/<seq>).

Port of `ucoslam_tpu/apps/analyze_logs.py` (the test through scipy).

Usage:
  python -m ucoslam_tpu_torch.apps.analyze_logs results/            # table
  python -m ucoslam_tpu_torch.apps.analyze_logs results/ --wilcoxon m1 m2
"""

from __future__ import annotations

import argparse
import os
import sys


def collect(root: str):
    from ucoslam_tpu_torch.apps.compare_logs import evaluate

    table = {}  # method -> {seq: (ate, pct)}
    for method in sorted(os.listdir(root)):
        mdir = os.path.join(root, method)
        if not os.path.isdir(mdir):
            continue
        for seq in sorted(os.listdir(mdir)):
            sdir = os.path.join(mdir, seq)
            est = os.path.join(sdir, "trajectory.txt")
            gt = os.path.join(sdir, "groundtruth.txt")
            if not (os.path.exists(est) and os.path.exists(gt)):
                continue
            out = evaluate(est, gt)
            if out:
                table.setdefault(method, {})[seq] = (out[0], out[1])
    return table


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("root")
    ap.add_argument("--wilcoxon", nargs=2, metavar=("METHOD_A", "METHOD_B"))
    args = ap.parse_args(argv)

    if not os.path.isdir(args.root):
        print(f"no such results directory: {args.root}")
        return 1
    table = collect(args.root)
    if not table:
        print("no results found")
        return 1
    seqs = sorted({s for m in table.values() for s in m})
    header = "sequence".ljust(24) + "".join(m.ljust(18) for m in sorted(table))
    print(header)
    for seq in seqs:
        row = seq.ljust(24)
        for m in sorted(table):
            if seq in table[m]:
                ate, pct = table[m][seq]
                row += f"{ate:.4f}/{pct:.2f}".ljust(18)
            else:
                row += "-".ljust(18)
        print(row)
    for m in sorted(table):
        ates = [v[0] for v in table[m].values()]
        print(f"mean ATE {m}: {sum(ates) / len(ates):.4f} over {len(ates)} seqs")

    if args.wilcoxon:
        from scipy.stats import wilcoxon

        a, b = args.wilcoxon
        common = sorted(set(table.get(a, {})) & set(table.get(b, {})))
        if len(common) < 3:
            print(f"wilcoxon: need >=3 common sequences, have {len(common)}")
            return 1
        xa = [table[a][s][0] for s in common]
        xb = [table[b][s][0] for s in common]
        stat, p = wilcoxon(xa, xb)
        print(
            f"wilcoxon({a} vs {b}) over {len(common)} seqs: W={stat:.1f} p={p:.4f}"
            + (" (significant at 0.05)" if p < 0.05 else "")
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
