"""Demo CLI: folder / video / directory modes with uncertainty-coloured
mesh overlays (the port's counterpart of the repo's `demo.py`).

    python -m poco_tpu_torch.cli.demo --mode folder --image_folder DIR \\
        [--output_folder out/demo] [--ckpt X.pt] [--detector refine|yolo|...] \\
        [--sideview] [--save_obj] [--device cuda|cpu]
    python -m poco_tpu_torch.cli.demo --mode video (--vid_file in.mp4 | \\
        --image_folder FRAMES_DIR) [--smooth] [--device cuda|cpu]
    python -m poco_tpu_torch.cli.demo --mode directory --image_folder PARENT \\
        [--dir_chunk i --dir_chunk_size n]
    python -m poco_tpu_torch.cli.demo --mode webcam --webcam_source FRAMES_DIR \\
        [--max_frames N] [--stream_sequential] [--smooth]

The flags are `demo.py`'s, under the same names and defaults, plus
`--device` (cuda unless `--device cpu`). A folder image is written under
its own name and format (`x.jpg` as a JPEG, quality 95, as cv2.imwrite
writes it: libjpeg on a host that has it, nvJPEG on the card's host), the
video mode's frames as `rendered/%06d.png`, assembled into an mp4 when
ffmpeg is on PATH, the webcam mode's as `stream_%06d.png`. `--vid_file`
needs ffmpeg; `--image_folder` takes a directory of same-size frames
instead. `--mode webcam` replays a directory of frames through the
depth-1 dispatch-ahead stream (`demo/stream.py`; `--stream_sequential`
turns the pipeline off) and prints its latencies and frames/s.

`--detector yolo` reads Darknet `yolov3.weights` from `--yolo_weights`,
$POCO_TPU_YOLO_WEIGHTS or data/detector/yolov3.weights (not in the repo;
nothing fetches it) and, without one, turns into `refine` with a notice.
`hog` and `refine` start from full-frame proposals (no HOG without
OpenCV). Refused, each naming its ROADMAP.md item: a camera or stream
URL as `--webcam_source` (cv2.VideoCapture), `--display`, `--wireframe`,
`--draw_keypoints`, video-mode `--sideview`, `--tracking_method pose`,
`--detector maskrcnn` and YouTube URLs.
TF32 is switched off for cuBLAS and cuDNN.
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import time

import torch

ROADMAP = "ROADMAP.md queue A item 4"


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cfg", default="configs/poco_cliff.yaml")
    parser.add_argument("--ckpt", default=None,
                        help="torch .pt/.ckpt file, or a run logdir holding one")
    parser.add_argument("--inf_model", default="best",
                        help="checkpoint selection inside a logdir "
                             "(best / best_mpjpe_var / latest)")
    parser.add_argument("--smpl_dir", default=None)
    parser.add_argument("--mode", default="folder",
                        choices=["video", "folder", "directory", "webcam"])
    parser.add_argument("--vid_file", default=None,
                        help="video to extract with ffmpeg (video mode); without it "
                             "--image_folder is the frame directory")
    parser.add_argument("--image_folder", default="demo_data/images")
    parser.add_argument("--output_folder", default="out/demo",
                        help="overlays go here, under each input's own name and format")
    parser.add_argument(
        "--detector", default="refine",
        choices=["yolo", "maskrcnn", "full_frame", "hog", "refine", "uncert"],
        help="yolo: YOLOv3 on the device (needs yolov3.weights); refine "
             "(default): full-frame proposals refined by the model's own "
             "keypoints; uncert: tiled windows scored by the predicted "
             "uncertainty; hog: the full-frame proposal (no HOG without "
             "OpenCV); full_frame: one whole-frame box; maskrcnn: refused",
    )
    parser.add_argument("--yolo_weights", default=None,
                        help="path to Darknet yolov3.weights (default: "
                             "$POCO_TPU_YOLO_WEIGHTS or data/detector/yolov3.weights)")
    parser.add_argument("--yolo_img_size", type=int, default=416,
                        help="input image size for the yolo detector")
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--tracker_batch_size", type=int, default=12)
    parser.add_argument("--exp", default="",
                        help="short experiment tag appended to output names")
    parser.add_argument("--skip_frame", type=int, default=1,
                        help="process every Nth image in folder mode")
    parser.add_argument("--no_kinematic_uncert", action="store_false",
                        help="disable kinematic-chain uncertainty accumulation "
                             "(on unless this flag is given, as in the reference)")
    parser.add_argument("--display", action="store_true", help="refused (a cv2 window)")
    parser.add_argument("--tracking_method", default="bbox", choices=["bbox", "pose"])
    parser.add_argument("--staf_dir", default=None, help="unused: pose tracking is refused")
    parser.add_argument("--smooth", action="store_true")
    parser.add_argument("--min_cutoff", type=float, default=0.004)
    parser.add_argument("--beta", type=float, default=0.7)
    parser.add_argument("--no_render", action="store_true")
    parser.add_argument("--webcam_source", default="0",
                        help="webcam mode: a directory of frames to replay (a camera index "
                             "or a stream URL is refused: cv2.VideoCapture)")
    parser.add_argument("--max_frames", type=int, default=None)
    parser.add_argument("--stream_sequential", action="store_true",
                        help="webcam mode without the depth-1 dispatch-ahead pipeline")
    parser.add_argument("--render_crop", action="store_true",
                        help="render the overlay on the 224px crop instead of the frame")
    parser.add_argument("--no_uncert_color", action="store_true")
    parser.add_argument("--sideview", action="store_true",
                        help="folder mode: a side view beside each frame")
    parser.add_argument("--wireframe", action="store_true", help="refused (cv2.polylines)")
    parser.add_argument("--save_obj", action="store_true")
    parser.add_argument("--draw_keypoints", action="store_true", help="refused (cv2.circle)")
    parser.add_argument("--dir_chunk_size", type=int, default=-1)
    parser.add_argument("--dir_chunk", type=int, default=0)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    if args.exp:
        args.output_folder = args.output_folder.rstrip("/") + "_" + args.exp
    return args


def refuse_unported(args) -> None:
    """Raise for every mode and flag the port does not have."""
    refused = []
    if args.mode == "webcam" and not osp.isdir(args.webcam_source):
        refused.append(f"--webcam_source {args.webcam_source!r}: a camera or stream URL "
                       "(cv2.VideoCapture; a directory of frames replays)")
    if args.display:
        refused.append("--display (a cv2 window)")
    if args.wireframe:
        refused.append("--wireframe (cv2.polylines)")
    if args.draw_keypoints:
        refused.append("--draw_keypoints (cv2.circle)")
    if args.mode == "video" and args.sideview:
        refused.append('video-mode --sideview (its "Other View" caption is cv2.putText)')
    if args.tracking_method == "pose":
        refused.append("--tracking_method pose (utils/pose_tracker.py, an external "
                       "OpenPose/STAF binary)")
    if args.detector == "maskrcnn":
        refused.append("--detector maskrcnn (the Mask R-CNN option)")
    if args.vid_file and args.vid_file.startswith(("https://", "http://")):
        refused.append("a --vid_file URL (YouTube download needs the network)")
    if refused:
        raise SystemExit(f"not ported: {'; '.join(refused)}; see {ROADMAP}")


def build_tester(args):
    from ..config import model_config_from_hparams, update_hparams
    from ..demo.tester import PocoTester
    from ..demo.tracker import full_frame_detector, hog_person_detector
    from ..demo.yolo import make_yolo_detector
    from ..device import resolve_device
    from ..models.poco import POCO
    from ..smpl.assets import resolve_smpl_params
    from ..utils.checkpoint import load_checkpoint_into

    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    hparams = update_hparams(args.cfg)
    smpl = resolve_smpl_params(args.smpl_dir, "neutral", device)
    torch.manual_seed(0)
    model = POCO(model_config_from_hparams(hparams)).to(device).eval()
    if args.ckpt:
        load_checkpoint_into(model, args.ckpt, inf_model=args.inf_model)
    else:
        print("no --ckpt: random weights (torch seed 0); overlays may fall off-screen")

    detector = hog_person_detector if args.detector in ("hog", "refine") else full_frame_detector
    if args.detector == "yolo":
        yolo = make_yolo_detector(args.yolo_weights, img_size=args.yolo_img_size,
                                  batch_size=args.tracker_batch_size, device=device)
        if yolo is None:
            print("yolov3.weights not found (--yolo_weights / $POCO_TPU_YOLO_WEIGHTS / "
                  "data/detector/) — falling back to --detector refine")
            args.detector = "refine"
            detector = hog_person_detector
        else:
            detector = yolo
    # the reference demo forces KINEMATIC_UNCERT from this store_false flag
    tester = PocoTester(model, smpl, detector=detector, batch_size=args.batch_size,
                        kinematic_uncert=bool(args.no_kinematic_uncert))
    if args.detector == "refine":
        tester.detector = tester.make_refined_detector(detector)
    elif args.detector == "uncert":
        tester.detector = tester.make_uncert_detector()
    return tester


def _print_stages(tester) -> None:
    print("stage seconds: " + json.dumps(
        {k: round(v, 6) for k, v in sorted(tester.stage_seconds.items())}))


def run_video(args, tester) -> dict:
    from ..utils.demo_utils import has_ffmpeg, images_to_video, video_to_images

    out_dir = args.output_folder
    os.makedirs(out_dir, exist_ok=True)
    if args.vid_file:
        stem = osp.splitext(osp.basename(args.vid_file))[0]
        img_folder, n_frames, _ = video_to_images(
            args.vid_file, osp.join(out_dir, f"frames_{stem}"), return_info=True)
    else:
        from ..data.inference import images_in_folder

        img_folder = args.image_folder
        stem = osp.basename(osp.normpath(img_folder))
        n_frames = len(images_in_folder(img_folder))
    t0 = time.time()
    tracks = tester.run_tracking(img_folder,
                                 cache_file=osp.join(out_dir, "tracking_results.pkl"))
    results = tester.run_on_video(img_folder, tracks=tracks, smooth=args.smooth,
                                  min_cutoff=args.min_cutoff, beta=args.beta)
    print(f"poco FPS: {n_frames / max(time.time() - t0, 1e-9):.2f} "
          f"({n_frames} frames, {len(results)} tracks)")
    if not args.no_render:
        render_dir = osp.join(out_dir, "rendered")
        tester.render_results(results, img_folder, render_dir,
                              uncert_color=not args.no_uncert_color,
                              uncert_log=osp.join(out_dir, "uncertainty.log"))
        tag = f"_{args.exp}" if args.exp else ""
        if has_ffmpeg():
            images_to_video(render_dir, osp.join(out_dir, f"{stem}{tag}_poco.mp4"))
        else:
            print(f"ffmpeg not on PATH: no mp4; the frames are in {render_dir}")
    _print_stages(tester)
    return results


def run_folder(args, tester) -> list:
    t0 = time.time()
    results = tester.run_on_image_folder(
        args.image_folder,
        output_folder=args.output_folder,
        render=not args.no_render,
        sideview=args.sideview,
        save_obj=args.save_obj,
        uncert_color=not args.no_uncert_color,
        skip_frame=args.skip_frame,
        render_crop=args.render_crop,
    )
    n = sum(len(r.get("bboxes", [])) for r in results)
    print(f"poco FPS: {n / max(time.time() - t0, 1e-9):.2f} ({n} crops)")
    _print_stages(tester)
    return results


def run_webcam(args, tester) -> dict:
    """The stream over a replayed directory (`demo/stream.py`)."""
    from ..demo.stream import open_source, run_stream

    source = open_source(args.webcam_source, max_frames=args.max_frames)
    stats = run_stream(
        tester, source,
        output_folder=None if args.no_render else args.output_folder,
        smooth=args.smooth, min_cutoff=args.min_cutoff, beta=args.beta,
        uncert_color=not args.no_uncert_color, pipeline=not args.stream_sequential,
    )
    print(f"poco stream: {stats['frames']} frames, e2e p50 {stats['e2e_ms_p50']} ms "
          f"(p90 {stats['e2e_ms_p90']}), model p50 {stats['model_ms_p50']} ms "
          f"(p90 {stats['model_ms_p90']}), {stats['fps']} fps")
    return stats


def run_directory(args, tester) -> dict:
    subdirs = sorted(
        d for d in os.listdir(args.image_folder)
        if osp.isdir(osp.join(args.image_folder, d))
    )
    if args.dir_chunk_size > 0:
        s = args.dir_chunk * args.dir_chunk_size
        subdirs = subdirs[s:s + args.dir_chunk_size]
    out = {}
    for d in subdirs:
        sub_args = argparse.Namespace(**vars(args))
        sub_args.image_folder = osp.join(args.image_folder, d)
        sub_args.output_folder = osp.join(args.output_folder, d)
        out[d] = run_folder(sub_args, tester)
    return out


def main(argv=None):
    args = parse_args(argv)
    refuse_unported(args)
    tester = build_tester(args)
    run = {"video": run_video, "folder": run_folder, "directory": run_directory,
           "webcam": run_webcam}[args.mode]
    return run(args, tester)


if __name__ == "__main__":
    main()
