"""Offline 3DPW error report from a dumped evaluation pkl (the port's
counterpart of the repo's `tools/compute_error.py`).

    python -m poco_tpu_torch.cli.compute_error --result_file \\
        logs/.../evaluation_results_3dpw.pkl [--out report.json]

Re-slices the per-sample results that the trainer saves
(`evaluation_results_<VAL_DS>.pkl`: imgname, mpjpe, pampjpe, v2v in mm)
into the All / Test-sequences / Occluded-sequences splits
(`eval.runner.pw3d_split_report`; reference pocolib/utils/compute_error.py
:29-85) and prints the report as JSON. Reads the port's plain pickles and,
where joblib is installed, the JAX trainer's joblib dumps too.
"""

from __future__ import annotations

import argparse
import json
import pickle


def load_results(path: str) -> dict:
    try:
        import joblib
    except ImportError:
        with open(path, "rb") as f:
            return pickle.load(f)
    return joblib.load(path)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--result_file", required=True)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)

    from ..eval.runner import pw3d_split_report

    payload = load_results(args.result_file)
    report = pw3d_split_report(payload["imgname"], payload["mpjpe"], payload["pampjpe"],
                               payload["v2v"])
    print(json.dumps(report, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return report


if __name__ == "__main__":
    main()
