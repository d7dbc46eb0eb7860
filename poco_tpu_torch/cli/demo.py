"""Demo CLI: folder / video / directory modes with uncertainty-coloured
mesh overlays (the port's counterpart of the repo's `demo.py`).

    python -m poco_tpu_torch.cli.demo --mode folder --image_folder DIR \\
        [--output_folder out/demo] [--ckpt X.pt] [--detector refine|yolo|...] \\
        [--sideview] [--save_obj] [--draw_keypoints] [--device cuda|cpu]
    python -m poco_tpu_torch.cli.demo --mode video (--vid_file in.mp4|in.avi|URL | \\
        --image_folder FRAMES_DIR) [--smooth] [--sideview] [--wireframe] [--display] \\
        [--tracking_method pose [--staf_dir STAF]] [--device cuda|cpu]
    python -m poco_tpu_torch.cli.demo --mode directory --image_folder PARENT \\
        [--dir_chunk i --dir_chunk_size n]
    python -m poco_tpu_torch.cli.demo --mode webcam --webcam_source \\
        (FRAMES_DIR | N | URL | FILE) [--max_frames N] [--stream_sequential] [--smooth]

The flags are `demo.py`'s, under the same names and defaults, plus
`--device` (cuda unless `--device cpu`). A folder image is written under
its own name and format (`x.jpg` as a JPEG, quality 95, as cv2.imwrite
writes it: libjpeg on a host that has it, nvJPEG on the card's host), the
video mode's frames as `rendered/%06d.png`, the webcam mode's as
`stream_%06d.png`.

Video and stream sources take the JAX package's routes where ffmpeg or
cv2 is installed, and a Motion-JPEG route of the port's own where
neither is (`utils/mjpeg.py`): `--vid_file` is extracted
by ffmpeg, else cv2, else, for an MJPG `.avi`, by copying its stored
JPEGs out; the rendered frames become `<stem>_poco.mp4` (ffmpeg, else
cv2's mp4v) or, with neither, `<stem>_poco.avi` in Motion-JPEG. Before
extraction the video's frame size is probed (cv2, else the AVI header)
and the tester warmed up at it (`PocoTester.warmup`); `--image_folder`
takes a directory of same-size frames instead. A YouTube URL is
downloaded with pytube or yt-dlp where installed (else the run stops,
naming them). `--mode webcam` streams a directory of frames, a camera
index, a URL or a video file through cv2.VideoCapture where cv2 is
installed; without cv2, a directory, an MJPG `.avi` or an HTTP
Motion-JPEG stream (`multipart/x-mixed-replace`), through the depth-1
dispatch-ahead stream (`demo/stream.py`; `--stream_sequential` turns the
pipeline off), and prints its latencies and frames/s. `--display` shows
the frames in a cv2 window where there is one, else prints a notice once.

`--detector yolo` reads Darknet `yolov3.weights` from `--yolo_weights`,
$POCO_TPU_YOLO_WEIGHTS or data/detector/yolov3.weights (not in the repo;
nothing fetches it) and, without one, turns into `refine` with a notice.
`--detector maskrcnn` is torchvision's Mask R-CNN with the weights file
$POCO_TPU_MASKRCNN_WEIGHTS; without both it falls back to `yolo` with the
JAX demo's notice. `hog` and `refine` start from full-frame proposals (no
HOG without OpenCV). As in `demo.py`, `--draw_keypoints` marks the folder
mode's projected joints, `--wireframe` draws the video mode's meshes as
face outlines, video-mode `--sideview` adds the captioned side view, and
`--tracking_method pose` reads keypoint tracks from posetrack JSON in
`<output_folder>/posetrack` (written there first by the STAF OpenPose
binary when `--staf_dir` is given; `utils/pose_tracker.py`). The drawing
is drawn without OpenCV: the wireframe and keypoints as cv2 draws them
(`runtime/native/poco_raster.cpp`), the caption as a model of OpenCV 5's
text (`viz/text.py`).
TF32 is switched off for cuBLAS and cuDNN.
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import time

import torch
from ..device import default_device


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
                        help="video (or YouTube URL) to extract with ffmpeg, cv2 or, for an "
                             "MJPG .avi, neither (video mode); without it --image_folder "
                             "is the frame directory")
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
             "OpenCV); full_frame: one whole-frame box; maskrcnn: torchvision's Mask "
             "R-CNN with $POCO_TPU_MASKRCNN_WEIGHTS (else yolo, with a notice)",
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
    parser.add_argument("--display", action="store_true",
                        help="show rendered frames in a cv2 window (a notice without one)")
    parser.add_argument("--tracking_method", default="bbox", choices=["bbox", "pose"])
    parser.add_argument("--staf_dir", default=None,
                        help="STAF build folder: run its OpenPose binary for "
                             "--tracking_method pose (else read existing JSON)")
    parser.add_argument("--smooth", action="store_true")
    parser.add_argument("--min_cutoff", type=float, default=0.004)
    parser.add_argument("--beta", type=float, default=0.7)
    parser.add_argument("--no_render", action="store_true")
    parser.add_argument("--webcam_source", default="0",
                        help="webcam mode: a directory of frames to replay; a camera index, "
                             "a stream URL or a video file with cv2; without cv2 an MJPG "
                             ".avi or an HTTP Motion-JPEG URL")
    parser.add_argument("--max_frames", type=int, default=None)
    parser.add_argument("--stream_sequential", action="store_true",
                        help="webcam mode without the depth-1 dispatch-ahead pipeline")
    parser.add_argument("--render_crop", action="store_true",
                        help="render the overlay on the 224px crop instead of the frame")
    parser.add_argument("--no_uncert_color", action="store_true")
    parser.add_argument("--sideview", action="store_true",
                        help="a side view beside each frame (captioned in video mode)")
    parser.add_argument("--wireframe", action="store_true",
                        help="video mode: draw the meshes as face outlines")
    parser.add_argument("--save_obj", action="store_true")
    parser.add_argument("--draw_keypoints", action="store_true",
                        help="folder mode: mark the projected 2D joints")
    parser.add_argument("--dir_chunk_size", type=int, default=-1)
    parser.add_argument("--dir_chunk", type=int, default=0)
    parser.add_argument("--device", default=default_device(),
                        help="cuda or cpu (default: $POCO_TPU_PLATFORM, else cuda)")
    args = parser.parse_args(argv)
    if args.exp:
        args.output_folder = args.output_folder.rstrip("/") + "_" + args.exp
    return args


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

    maskrcnn = None
    if args.detector == "maskrcnn":
        from ..demo.tracker import make_maskrcnn_detector

        maskrcnn = make_maskrcnn_detector(device=device)
        if maskrcnn is None:
            print(
                "--detector maskrcnn: torchvision (or its pretrained "
                "weights) is unavailable in this environment; falling "
                "back to --detector yolo (TPU-native)."
            )
            args.detector = "yolo"
    detector = hog_person_detector if args.detector in ("hog", "refine") else full_frame_detector
    if maskrcnn is not None:
        detector = maskrcnn
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
    from ..utils.demo_utils import (download_youtube_clip, images_to_video,
                                    video_frame_size, video_to_images)

    out_dir = args.output_folder
    os.makedirs(out_dir, exist_ok=True)
    vid_file = args.vid_file
    if vid_file and vid_file.startswith(("https://www.youtube.com", "https://youtu.be")):
        print(f"downloading YouTube video {vid_file}")
        vid_file = download_youtube_clip(vid_file, osp.join(out_dir, "video_downloads"))
        if vid_file is None:
            raise SystemExit(
                "YouTube download failed (install pytube or yt-dlp, "
                "and check the url)"
            )
    if vid_file:
        # per-video frame dir: a longer earlier video's frames would stay in it
        stem = osp.splitext(osp.basename(vid_file))[0]
        tester.warmup(video_frame_size(vid_file))
        img_folder, n_frames, _ = video_to_images(
            vid_file, osp.join(out_dir, f"frames_{stem}"), return_info=True)
    else:
        from ..data.inference import images_in_folder
        from ..runtime.loader import image_size

        img_folder = args.image_folder
        stem = osp.basename(osp.normpath(img_folder))
        frames = images_in_folder(img_folder)
        n_frames = len(frames)
        tester.warmup(image_size(frames[0]) if frames else None)
    t0 = time.time()
    if args.tracking_method == "pose":
        from ..utils.pose_tracker import run_posetracker

        tracks = run_posetracker(img_folder, staf_folder=args.staf_dir,
                                 posetrack_output_folder=osp.join(out_dir, "posetrack"))
    else:
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
                              wireframe=args.wireframe,
                              uncert_log=osp.join(out_dir, "uncertainty.log"),
                              display=args.display,
                              sideview=args.sideview)
        tag = f"_{args.exp}" if args.exp else ""
        images_to_video(render_dir, osp.join(out_dir, f"{stem}{tag}_poco.mp4"))
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
        draw_keypoints=args.draw_keypoints,
        skip_frame=args.skip_frame,
        render_crop=args.render_crop,
        display=args.display,
    )
    n = sum(len(r.get("bboxes", [])) for r in results)
    print(f"poco FPS: {n / max(time.time() - t0, 1e-9):.2f} ({n} crops)")
    _print_stages(tester)
    return results


def run_webcam(args, tester) -> dict:
    """The stream over `--webcam_source` (`demo/stream.py`)."""
    from ..demo.stream import open_source, run_stream

    source = open_source(args.webcam_source, max_frames=args.max_frames)
    stats = run_stream(
        tester, source,
        output_folder=None if args.no_render else args.output_folder,
        smooth=args.smooth, min_cutoff=args.min_cutoff, beta=args.beta,
        uncert_color=not args.no_uncert_color, display=args.display,
        render=not args.no_render, max_frames=args.max_frames,
        pipeline=not args.stream_sequential,
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
    tester = build_tester(args)
    run = {"video": run_video, "folder": run_folder, "directory": run_directory,
           "webcam": run_webcam}[args.mode]
    return run(args, tester)


if __name__ == "__main__":
    main()
