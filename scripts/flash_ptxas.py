#!/usr/bin/env python3
"""Registers and spills of the flash kernels, as ptxas reports them when
a checkout's kernel library is built (one card's toolkit, `sm_90a`).

    python3 scripts/flash_ptxas.py [--root DIR] [--all]

`--root` takes another checkout (e.g. an unpacked parent commit), whose
`src/` is imported and whose kernels are built (or whose build log is read
where the library exists), so that two versions are compared by the same
compiler. Prints one JSON line: for each flash forward, dK/dV and dQ
instance at head dims 128 and 256 (NC = 8 and 16; `--all` for every
instance), its registers and bytes of spill stores and loads.
"""
import argparse
import json
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(ROOT))
    ap.add_argument("--all", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root) / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import ptxas_table
    from repro_torch.kernels import build

    info = build.build()
    rows = {}
    for row in ptxas_table(info.ptxas):
        name, report = row.split(": ", 1)
        if not any(k in name for k in ("flash_attn_kernel", "dkdv_kernel",
                                       "dq_kernel")):
            continue
        if not args.all and not any(f", {nc}, " in name for nc in (8, 16)):
            continue
        rows[name] = {
            "registers": int(re.search(r"Used (\d+) registers",
                                       report).group(1)),
            "spill_stores": int(re.search(r"(\d+) bytes spill stores",
                                          report).group(1)),
            "spill_loads": int(re.search(r"(\d+) bytes spill loads",
                                         report).group(1))}
    print(json.dumps({"root": args.root, "build_s": info.seconds,
                      "instances": rows}), flush=True)


if __name__ == "__main__":
    main()
