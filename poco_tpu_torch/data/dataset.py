"""npz-annotation dataset and batching on the host (port of
`poco_tpu.data.dataset`).

Reference contract: pocolib/dataset/base_dataset.py. The npz schema is
unchanged: imgname, center, scale, and optionally pose (72), shape (10),
S (24, 4), part (24, 3), openpose (25, 3), gender, has_smpl, person_id,
var. Items stay numpy, with each crop HWC in [0, 255]; normalization and
the GT meshes happen on the device, in the eval step. Images are decoded
and cropped by the port's loader (`runtime/loader.py`, no OpenCV): a
whole batch at once on its C++ thread pool (`get_batch`, which the
`DataLoader` uses), or one item at a time through the same decode and
warp, so both give the same crops. Synthetic occlusion (`occluders=`)
pastes `data/occlusion.py`'s patches with its own random stream. The
`DataLoader` shards each global batch over processes (`num_shards`,
`shard_index`), as the JAX package's does.
"""

from __future__ import annotations

import inspect
import os
import queue
import threading
import time
import warnings
from typing import Any, Iterator

import numpy as np

from ..constants import IMG_RES
from ..parallel.mesh import shard_bounds
from ..runtime import loader
from . import occlusion
from .transforms import (
    AugmentParams,
    affine_output_to_source,
    convert_crop_coords_to_orig_img,
    process_image,
    process_keypoints_2d,
    process_keypoints_3d,
    process_pose,
    sample_augment_params,
)


def calculate_bbox_info_np(center, scale, orig_shape):
    img_h, img_w = float(orig_shape[0]), float(orig_shape[1])
    focal = np.sqrt(img_h**2 + img_w**2)
    b = scale * 200.0
    return np.array(
        [
            (center[0] - img_w / 2.0) / focal * 2.8,
            (center[1] - img_h / 2.0) / focal * 2.8,
            (b - 0.24 * focal) / (0.06 * focal),
        ],
        np.float32,
    )


def get_confident_frames(var: np.ndarray, threshold: float) -> np.ndarray:
    """Frames whose root uncertainty is below threshold (reference
    train_utils.py:31-45: the global uncertainty is joint 0's)."""
    return np.nonzero(np.asarray(var)[:, 0] < threshold)[0]


class PocoDataset:
    """BaseDataset equivalent over an npz annotation file.

    Args:
        npz_file: annotation archive (schema above).
        img_dir: image root joined with each imgname.
        is_train: enables augmentation.
        options: augmentation knobs (FLIP, NOISE_FACTOR, ROT_FACTOR,
            SCALE_FACTOR, UNCERT_THRESHOLD, IMG_RES, TEST_ROT, TEST_SCALE,
            USE_SYNTHETIC_OCCLUSION, OCC_AUG_DATASET); the defaults mirror
            config.py.
        occluders: occluder patches for synthetic occlusion (RGBA arrays
            from `occlusion.load_pascal_occluders` or
            `synthetic_occluders`; for OCC_AUG_DATASET "coco", the dict of
            `load_coco_occluders`), pasted into training crops when
            USE_SYNTHETIC_OCCLUSION is set.
    """

    def __init__(
        self,
        npz_file: str,
        img_dir: str = "",
        dataset_name: str = "",
        is_train: bool = True,
        use_augmentation: bool = True,
        ignore_3d: bool = False,
        num_images: int = 0,
        options: dict | None = None,
        occluders: list | dict | None = None,
        seed: int = 0,
    ):
        self.img_dir = img_dir
        self.dataset_name = dataset_name or os.path.basename(npz_file).split(".")[0]
        self.is_train = is_train
        self.use_augmentation = use_augmentation
        self.options = dict(
            FLIP=True, NOISE_FACTOR=0.4, ROT_FACTOR=30.0, SCALE_FACTOR=0.25,
            IMG_RES=IMG_RES, UNCERT_THRESHOLD=0.3,  # config.py:98 / reference :125
            TEST_ROT=0.0, TEST_SCALE=1.0,
        )
        self.options.update(options or {})
        self.occluders = occluders
        self.rng = np.random.RandomState(seed)
        # occlusion (and the read retry's wait) draw from a stream of their
        # own, so the per-item path and get_batch, which draws every row's
        # augmentation first, consume `rng` in the same order
        self.occ_rng = np.random.RandomState(None if seed is None else seed + 77_003)

        data = dict(np.load(npz_file, allow_pickle=True))
        n = len(data["imgname"])

        # Confident-frame subselection for POCO-labeled data
        # (base_dataset.py:60-71).
        if "var" in data:
            sel = get_confident_frames(data["var"], self.options["UNCERT_THRESHOLD"])
            data = {k: v[sel] for k, v in data.items()}
            n = len(data["imgname"])
        if num_images > 0:
            sel = self.rng.randint(0, n, size=num_images)
            data = {k: v[sel] for k, v in data.items()}
            n = num_images

        self.imgname = data["imgname"]
        self.center = data["center"].astype(np.float32)
        self.scale = data["scale"].astype(np.float32)

        if "pose" in data and not ignore_3d:
            self.pose = data["pose"].astype(np.float32)
            self.betas = data["shape"].astype(np.float32)
            self.has_smpl = data.get("has_smpl", np.ones(n, np.float32)).astype(np.float32)
        else:
            self.pose = np.zeros((n, 72), np.float32)
            self.betas = np.zeros((n, 10), np.float32)
            self.has_smpl = np.zeros(n, np.float32)

        if "S" in data and not ignore_3d:
            self.pose_3d = data["S"].astype(np.float32)
            self.has_pose_3d = 1.0
        else:
            self.pose_3d = np.zeros((n, 24, 4), np.float32)
            self.has_pose_3d = 0.0

        kp_gt = data.get("part", np.zeros((n, 24, 3))).astype(np.float32)
        kp_op = data.get("openpose", np.zeros((n, 25, 3))).astype(np.float32)
        self.keypoints = np.concatenate([kp_op, kp_gt], axis=1)

        gender = data.get("gender")
        if gender is not None:
            # m -> male, f -> female (the reference's two values,
            # base_dataset.py:101-104); anything else (e.g. the synthetic
            # sets' "n") -> -1 = neutral GT, not female.
            self.gender = np.array(
                [0 if str(g) == "m" else (1 if str(g) == "f" else -1) for g in gender],
                np.int32,
            )
        else:
            self.gender = -1 * np.ones(n, np.int32)
        self.person_id = data.get("person_id", -1 * np.ones(n, np.int32))

    def __len__(self) -> int:
        return len(self.imgname)

    def _load_image(self, index: int) -> np.ndarray:
        """The item's image, (H, W, 3) RGB uint8, through the loader."""
        path = os.path.join(self.img_dir, str(self.imgname[index]))
        try:
            return loader.decode_image(path)
        except FileNotFoundError:
            # one bounded retry for a transient file-system miss (the
            # reference sleeps 500-1000 s, base_dataset.py:276-283)
            time.sleep(self.occ_rng.uniform(0.5, 1.0))
            return loader.decode_image(path)

    def _sample_aug(self) -> AugmentParams:
        if self.is_train and self.use_augmentation:
            return sample_augment_params(
                self.rng,
                noise_factor=self.options["NOISE_FACTOR"],
                rot_factor=self.options["ROT_FACTOR"],
                scale_factor=self.options["SCALE_FACTOR"],
                use_flip=self.options["FLIP"],
            )
        # Eval-time fixed augmentation for robustness studies
        # (TESTING.TEST_ROT / TEST_SCALE).
        return AugmentParams(
            rot=float(self.options.get("TEST_ROT", 0.0)),
            scale=float(self.options.get("TEST_SCALE", 1.0)),
        )

    def _finish_item(
        self, index: int, aug: AugmentParams, crop: np.ndarray, orig_shape: np.ndarray
    ) -> dict[str, Any]:
        """The item dict of one sample around its crop."""
        center = self.center[index].copy()
        scale = float(self.scale[index])
        kp2d = process_keypoints_2d(
            self.keypoints[index].copy(), center, scale, aug, self.options["IMG_RES"]
        )
        bbox = np.array([[center[0], center[1], aug.scale * scale * 200.0]])
        kp_fullimg = convert_crop_coords_to_orig_img(
            bbox, kp2d[None].copy(), self.options["IMG_RES"]
        )[0]
        if (self.occluders is not None and self.is_train
                and self.options.get("USE_SYNTHETIC_OCCLUSION")):
            crop = self._occlude(crop, kp2d, scale)
        return {
            "img": crop,  # (R, R, 3) float32 [0, 255]; normalized on the device
            "pose": process_pose(self.pose[index], aug),
            "betas": self.betas[index].copy(),
            "pose_3d": process_keypoints_3d(self.pose_3d[index], aug),
            "keypoints": kp2d,
            "keypoints_fullimg": kp_fullimg,
            "has_smpl": np.float32(self.has_smpl[index]),
            "has_pose_3d": np.float32(self.has_pose_3d),
            "scale": np.float32(aug.scale * scale),
            "center": center.astype(np.float32),
            "orig_shape": orig_shape,
            "focal_length": np.float32(np.sqrt(orig_shape[0] ** 2 + orig_shape[1] ** 2)),
            "bbox_info": calculate_bbox_info_np(center, aug.scale * scale, orig_shape),
            "is_flipped": np.float32(aug.flip),
            "rot_angle": np.float32(aug.rot),
            "gender": np.int32(self.gender[index]),
            "sample_index": np.int32(index),
            "dataset_name": self.dataset_name,
            "imgname": str(self.imgname[index]),
        }

    def _occlude(self, crop: np.ndarray, kp2d: np.ndarray, scale: float) -> np.ndarray:
        """Synthetic occlusion of one crop (JAX `_finish_item`): COCO
        statistics, pastes at random places ("pascal_random") or near the
        visible keypoints (default)."""
        kind = str(self.options.get("OCC_AUG_DATASET", "pascal"))
        if kind == "coco":
            return occlusion.occlude_with_coco_objects(
                crop, kp2d, self.occluders, self.occ_rng, img_size=self.options["IMG_RES"])
        if kind == "pascal_random":
            return occlusion.occlude_with_objects(crop, self.occluders, self.occ_rng)
        return occlusion.occlude_with_objects_kp(crop, kp2d, scale, self.occluders,
                                                 self.occ_rng)

    def _item(self, index: int, aug: AugmentParams) -> dict[str, Any]:
        img = self._load_image(index)
        orig_shape = np.array(img.shape[:2], np.float32)
        crop = process_image(
            img, self.center[index], aug.scale * float(self.scale[index]), aug,
            self.options["IMG_RES"],
        )
        return self._finish_item(index, aug, crop, orig_shape)

    def __getitem__(self, index: int) -> dict[str, Any]:
        return self._item(index, self._sample_aug())

    def get_batch(self, indices, keep=None) -> dict[str, Any]:
        """A whole batch through the loader's threaded decode and warp.

        The augmentation of every index is drawn first, from the same
        stream in the same order as the per-item path, and the warp matrix
        is the per-item one (`transforms.affine_output_to_source`), so each
        row equals the item `__getitem__` gives. A file that fails to
        decode raises with its path.

        keep: positions (a slice or a list) of the rows to materialize,
        after the draws for all of `indices` (the JAX package's sharded
        loading: each process draws the global batch and builds its rows).
        The result then carries `_global_row_names`, the dataset name of
        every global row.
        """
        indices = [int(i) for i in indices]
        augs = [self._sample_aug() for _ in indices]
        names = None
        if keep is not None:
            names = [self.dataset_name] * len(indices)
            rows = (list(range(len(indices)))[keep] if isinstance(keep, slice)
                    else [int(k) for k in keep])
            indices = [indices[k] for k in rows]
            augs = [augs[k] for k in rows]
            if not indices:
                return {"_global_row_names": names}
        batch = self._materialize_batch(indices, augs)
        if names is not None:
            batch["_global_row_names"] = names
        return batch

    def _materialize_batch(self, indices: list[int], augs: list[AugmentParams]) -> dict[str, Any]:
        res = self.options["IMG_RES"]
        paths = [os.path.join(self.img_dir, str(self.imgname[i])) for i in indices]
        affines = np.stack([
            affine_output_to_source(self.center[i], a.scale * float(self.scale[i]) * 200.0,
                                    res, a.rot, a.flip)
            for i, a in zip(indices, augs)
        ])
        gains = np.stack([a.pixel_noise for a in augs])
        crops, dims = loader.batch_decode_affine(paths, affines, gains, res)
        return collate([
            self._finish_item(i, a, crops[k], dims[k].astype(np.float32))
            for k, (i, a) in enumerate(zip(indices, augs))
        ])


def collate(items: list[dict[str, Any]]) -> dict[str, Any]:
    """Stack item dicts into a numpy batch (strings become lists)."""
    batch: dict[str, Any] = {}
    for key in items[0]:
        vals = [it[key] for it in items]
        batch[key] = vals if isinstance(vals[0], str) else np.stack(vals)
    return batch


class ResumableSampler:
    """Shuffled index order that a checkpoint can resume mid-epoch: the
    epoch's permutation (seeded by seed + epoch) and a cursor (reference
    pocolib/utils/dataloader.py:7-64). As in the JAX package, the trainer
    resumes at epoch boundaries (its loader is seeded by the epoch) and
    does not use it; it is the utility for runs restarted by hand."""

    def __init__(self, n: int, shuffle: bool = True, seed: int = 0):
        self.n = n
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.cursor = 0
        self._perm = self._make_perm()

    def _make_perm(self) -> np.ndarray:
        order = np.arange(self.n)
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(order)
        return order

    def state_dict(self) -> dict:
        return {"epoch": self.epoch, "cursor": self.cursor, "seed": self.seed,
                "perm": self._perm.tolist()}

    def load_state_dict(self, state: dict) -> None:
        self.epoch = state["epoch"]
        self.cursor = state["cursor"]
        self.seed = state["seed"]
        self._perm = np.asarray(state["perm"])

    def next_epoch(self) -> None:
        self.epoch += 1
        self.cursor = 0
        self._perm = self._make_perm()

    def take(self, k: int) -> np.ndarray:
        idx = self._perm[self.cursor:self.cursor + k]
        self.cursor += len(idx)
        return idx

    @property
    def remaining(self) -> int:
        return self.n - self.cursor


class DataLoader:
    """Batches assembled on a background thread that keeps up to
    `prefetch` batches ready. The order is shuffled by a generator seeded
    with `seed` (the trainer passes the epoch, so a resumed epoch repeats
    its order); a dataset with `get_batch` reads a whole batch at once.

    Sharding over processes: with `num_shards` / `shard_index` (one shard
    a process), every process draws the same global order and yields its
    contiguous rows of each global batch; `batch_size` stays the global
    batch. A dataset whose `get_batch` takes `keep=` draws its per-row
    randomness for the whole global batch and builds only the kept rows
    (with `_global_row_names`), so the shards together are the one-process
    batch; another dataset is sliced, with a warning.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        drop_last: bool = True,
        prefetch: int = 2,
        seed: int = 0,
        num_shards: int = 1,
        shard_index: int = 0,
    ):
        if batch_size % num_shards:
            raise ValueError(
                f"global batch {batch_size} not divisible by {num_shards} loader shards"
            )
        if num_shards > 1 and not drop_last:
            raise ValueError(
                "sharded loading requires drop_last=True (a short final "
                "batch cannot be split evenly across processes)"
            )
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.rng = np.random.RandomState(seed)
        self.num_shards = num_shards
        self.shard_index = shard_index

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def __iter__(self) -> Iterator[dict[str, Any]]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        n_batches = len(self)
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        get_batch = getattr(self.dataset, "get_batch", None)
        sharded = self.num_shards > 1
        keeps = get_batch is not None and "keep" in inspect.signature(get_batch).parameters
        if sharded and not keeps and not getattr(type(self), "_warned_keepless_shard", False):
            # every process would consume the same augmentation stream on
            # other rows: the shards are then not the one-process batch
            type(self)._warned_keepless_shard = True
            warnings.warn(
                f"{type(self.dataset).__name__} has no get_batch(..., keep=...): sharded "
                "loading falls back to index slicing with a shared augmentation RNG "
                "stream — augmentations will be correlated across processes and differ "
                "from a single-process run", stacklevel=2,
            )
        lo, hi = shard_bounds(self.batch_size, self.num_shards, self.shard_index)

        def producer():
            try:
                for b in range(n_batches):
                    idxs = order[b * self.batch_size:(b + 1) * self.batch_size]
                    if sharded and keeps:
                        batch = get_batch(idxs, keep=slice(lo, hi))
                    else:
                        if sharded:
                            idxs = idxs[lo:hi]
                        batch = (get_batch(idxs) if get_batch is not None
                                 else collate([self.dataset[int(i)] for i in idxs]))
                    if not put(batch):
                        return
            except Exception as e:  # handed to the consumer, raised there
                put(e)
                return
            put(None)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            # a consumer that stops early (max_batches) releases the thread
            stop.set()
            thread.join(timeout=60)
