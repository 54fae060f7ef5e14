"""Command-line interface — the launch-file / rosrun analog.

Replaces the reference's operational entry points (launch/stereo_nodes*.launch
+ `rostopic pub acquire_images ...`) with one CLI, the port's counterpart
of ``python -m ug_stereomatcher_tpu``:

    python -m ug_stereomatcher_tpu_torch match LEFT RIGHT [-o OUT]
        [--foveated | --consistency] [--panel] [--ext .tif|.npy]
    python -m ug_stereomatcher_tpu_torch batch MANIFEST [-o OUT] [--foveated]
        [--cal-left calL.xml --cal-right calR.xml] [--save-clouds]
    python -m ug_stereomatcher_tpu_torch cloud LEFT RIGHT --cal-left X
        --cal-right Y [-o cloud.pcd]
    python -m ug_stereomatcher_tpu_torch eval [--markdown]
    python -m ug_stereomatcher_tpu_torch bench [--mode mode1|foveated]
        [--height H --width W]

Every command runs on ``--device`` (default ``cuda``; ``cpu`` runs the
kernels' plain versions).  ``.npy`` images, dumps and ``.json`` configs
need neither PIL nor PyYAML.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _add_device_arg(p):
    p.add_argument("--device", default="cuda",
                   help="torch device to match on (default cuda; cpu runs "
                        "the kernels' plain PyTorch versions)")


def _add_engine_args(p):
    p.add_argument("--config", default=None,
                   help="YAML/JSON MatcherConfig file (the launch-file "
                        "analog); flags below override its values")
    p.add_argument("--fovea-level", type=int, default=None,
                   help="pyramid level defining the fovea size (default 7)")
    p.add_argument("--interp", choices=["nearest", "bilinear"],
                   default=None,
                   help="resampling (nearest = reference parity)")
    p.add_argument("--early-exit-delta", type=float, default=None,
                   help="convergence early exit threshold (non-parity; "
                        "accuracy-safe values: 0.1 nearest, 0.02 "
                        "bilinear)")
    _add_device_arg(p)


def _engine(args):
    import dataclasses

    from ug_stereomatcher_tpu_torch import MatcherConfig, StereoEngine
    cfg = (MatcherConfig.from_file(args.config) if args.config
           else MatcherConfig())
    overrides = {k: v for k, v in (("fovea_level", args.fovea_level),
                                   ("interp", args.interp),
                                   ("early_exit_delta",
                                    args.early_exit_delta))
                 if v is not None}
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return StereoEngine(cfg, device=args.device)


def cmd_match(args) -> int:
    import os

    import numpy as np
    from ug_stereomatcher_tpu_torch.device import to_numpy
    from ug_stereomatcher_tpu_torch.io.dumps import (save_disparity_maps,
                                                     save_foveated_stack)
    from ug_stereomatcher_tpu_torch.io.image import load_image
    if args.foveated and (args.consistency or args.panel):
        print("error: --consistency/--panel apply to full-resolution "
              "matching and cannot be combined with --foveated",
              file=sys.stderr)
        return 2
    eng = _engine(args)
    left = load_image(args.left)
    right = load_image(args.right)
    t0 = time.perf_counter()
    extra = {}
    if args.foveated:
        res = eng.match_foveated(left, right)
        paths = save_foveated_stack(res, args.out, ext=args.ext)
    elif args.consistency:
        res, mask, err = eng.match_with_consistency(left, right,
                                                    tau=args.tau)
        paths = save_disparity_maps(res, args.out, ext=args.ext)
        mask = to_numpy(mask)
        mpath = os.path.join(args.out, "consistency_mask.npy")
        np.save(mpath, mask)
        paths["mask"] = mpath
        extra["consistent_fraction"] = round(float(mask.mean()), 4)
    else:
        res = eng.match(left, right)
        paths = save_disparity_maps(res, args.out, ext=args.ext)
    if args.panel:
        from ug_stereomatcher_tpu_torch.io.viz import render_panel
        paths["panel"] = render_panel(
            res, os.path.join(args.out, "panel.png"))
    dt = time.perf_counter() - t0
    print(json.dumps({"seconds": round(dt, 3), "outputs": paths, **extra}))
    return 0


def cmd_batch(args) -> int:
    from ug_stereomatcher_tpu_torch.geom.calibration import StereoCalibration
    from ug_stereomatcher_tpu_torch.pipeline import (BatchRunner,
                                                     ImageListCapture)
    calib = None
    if args.cal_left and args.cal_right:
        calib = StereoCalibration.from_xml(args.cal_left, args.cal_right)
    runner = BatchRunner(_engine(args), foveated=args.foveated,
                         calibration=calib, out_dir=args.out,
                         save_clouds=args.save_clouds, dump_ext=args.ext)
    cap = ImageListCapture(args.manifest,
                           camera_info_left=args.cal_left,
                           camera_info_right=args.cal_right)
    results = runner.run(cap, max_pairs=args.max_pairs)
    for r in results:
        print(json.dumps({"pair": r.index,
                          "seconds": round(r.match_seconds, 3),
                          "outputs": r.dump_paths}))
    return 0


def cmd_cloud(args) -> int:
    from ug_stereomatcher_tpu_torch import native
    from ug_stereomatcher_tpu_torch.geom.calibration import StereoCalibration
    from ug_stereomatcher_tpu_torch.geom.pointcloud import (
        disparity_to_pointcloud)
    from ug_stereomatcher_tpu_torch.io.image import load_image
    eng = _engine(args)
    calib = StereoCalibration.from_xml(args.cal_left, args.cal_right)
    left = load_image(args.left)
    right = load_image(args.right)
    res = eng.match(left, right)
    cloud = disparity_to_pointcloud(calib, res.disparity_h, res.disparity_v,
                                    left, sampling=args.sampling)
    if args.out.endswith(".ply"):
        native.write_ply(args.out, cloud.xyz, cloud.rgb)
    else:
        native.write_pcd(args.out, cloud.xyz, cloud.rgb)
    print(json.dumps({"points": len(cloud), "output": args.out}))
    return 0


def cmd_eval(args) -> int:
    """Reproducible accuracy harness: the nearest-vs-bilinear A/B table of
    docs/ACCURACY.md (synthetic exact-ground-truth scenes; the offline
    stand-in for the Glasgow 80-pair evaluation, README.md:32-40)."""
    from ug_stereomatcher_tpu_torch.eval import (accuracy_table,
                                                 format_accuracy_markdown)
    interps = args.interp.split(",") if args.interp else ("nearest",
                                                          "bilinear")
    tables = accuracy_table(height=args.height, width=args.width,
                            interps=interps, seed=args.seed,
                            device=args.device)
    if args.markdown:
        print(format_accuracy_markdown(tables))
        return 0
    for interp, reports in tables.items():
        for kind, r in reports.items():
            print(json.dumps({"interp": interp, "scene": kind,
                              **{k: round(v, 5) if isinstance(v, float) else v
                                 for k, v in r.as_dict().items()}}))
    return 0


def cmd_bench(args) -> int:
    """The bench (bench.py): ``--mode``, ``--height``, ``--width`` and
    ``--device cpu`` set BENCH_MODE, BENCH_H, BENCH_W and
    BENCH_PLATFORM=cpu; what is not given keeps the environment's value
    (BENCH_MODE=all by default)."""
    import os

    from ug_stereomatcher_tpu_torch import bench
    if args.mode:
        os.environ["BENCH_MODE"] = args.mode
    if args.height:
        os.environ["BENCH_H"] = str(args.height)
    if args.width:
        os.environ["BENCH_W"] = str(args.width)
    if args.device == "cpu":
        os.environ["BENCH_PLATFORM"] = "cpu"
    elif args.device:
        os.environ.pop("BENCH_PLATFORM", None)
    return bench.main() or 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="ug_stereomatcher_tpu_torch",
        description="Dense stereo matcher on PyTorch + CUDA (two-axis "
                    "disparity + confidence; full-resolution and foveated "
                    "modes)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("match", help="match one stereo pair")
    p.add_argument("left")
    p.add_argument("right")
    p.add_argument("-o", "--out", default="out")
    p.add_argument("--foveated", action="store_true")
    p.add_argument("--consistency", action="store_true",
                   help="also run right->left and write an LR validity mask")
    p.add_argument("--tau", type=float, default=1.0,
                   help="LR consistency threshold in pixels")
    p.add_argument("--panel", action="store_true",
                   help="write a colorized H|V|C panel PNG")
    p.add_argument("--ext", choices=[".tif", ".npy"], default=".tif",
                   help="file type of the H/V/C dumps (.npy needs no PIL)")
    _add_engine_args(p)
    p.set_defaults(fn=cmd_match)

    p = sub.add_parser("batch", help="run a stereo-pair manifest")
    p.add_argument("manifest")
    p.add_argument("-o", "--out", default="out")
    p.add_argument("--foveated", action="store_true")
    p.add_argument("--cal-left")
    p.add_argument("--cal-right")
    p.add_argument("--save-clouds", action="store_true")
    p.add_argument("--max-pairs", type=int, default=None)
    p.add_argument("--ext", choices=[".tif", ".npy"], default=".tif",
                   help="file type of the H/V/C dumps (.npy needs no PIL)")
    _add_engine_args(p)
    p.set_defaults(fn=cmd_batch)

    p = sub.add_parser("cloud", help="stereo pair -> RGB point cloud")
    p.add_argument("left")
    p.add_argument("right")
    p.add_argument("--cal-left", required=True)
    p.add_argument("--cal-right", required=True)
    p.add_argument("-o", "--out", default="cloud.pcd")
    p.add_argument("--sampling", type=int, default=1)
    _add_engine_args(p)
    p.set_defaults(fn=cmd_cloud)

    p = sub.add_parser("eval", help="accuracy table on exact-ground-truth "
                                    "synthetic scenes (docs/ACCURACY.md)")
    p.add_argument("--height", type=int, default=192)
    p.add_argument("--width", type=int, default=256)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--interp", default=None,
                   help="comma-separated interp modes (default both)")
    p.add_argument("--markdown", action="store_true",
                   help="emit the ACCURACY.md tables instead of JSON lines")
    _add_device_arg(p)
    p.set_defaults(fn=cmd_eval)

    p = sub.add_parser("bench", help="run the standard benchmark "
                                     "(bench.py; value gates on every line)")
    p.add_argument("--mode", choices=["mode1", "foveated"], default=None,
                   help="one latency line (default: BENCH_MODE, else all)")
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--device", default=None,
                   help="cuda or cpu (default: BENCH_PLATFORM=cpu where "
                        "set, else cuda)")
    p.set_defaults(fn=cmd_bench)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
