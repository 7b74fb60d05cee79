"""Dataset integrity audit — the ``statastical.py`` equivalent.

Port of slam_maskrcnn_tpu/samples/dataset_audit.py (host-side, file
names only) = ``Mask_RCNN/statastical.py:14-49``: count rgb/depth files per
whole-second timestamp and write an image_number report (frame-rate /
pairing sanity check for a TUM sequence).
"""

from __future__ import annotations

import argparse
import glob
import os
from collections import Counter


def audit(root: str, out_path: str | None = None) -> dict:
    report = {}
    for stream in ("rgb", "depth", "mask"):
        files = sorted(glob.glob(os.path.join(root, stream, "*.png")))
        secs = Counter()
        for f in files:
            stem = os.path.basename(f).rsplit(".png", 1)[0]
            try:
                secs[int(float(stem))] += 1
            except ValueError:
                continue
        report[stream] = dict(total=len(files),
                              seconds=len(secs),
                              per_second=dict(sorted(secs.items())))
    lines = []
    for stream, r in report.items():
        lines.append(f"{stream}: {r['total']} files over {r['seconds']}s")
        for sec, n in r["per_second"].items():
            lines.append(f"  {sec}: {n}")
    text = "\n".join(lines)
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "w") as f:
            f.write(text + "\n")
    return report


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset", required=True)
    p.add_argument("--out", default="test_log/image_number.txt")
    a = p.parse_args(argv)
    r = audit(a.dataset, a.out)
    for stream, rr in r.items():
        print(f"{stream}: {rr['total']} files / {rr['seconds']} seconds")
    return r


if __name__ == "__main__":
    main()
