"""Dataset registry and loader (counterpart of
tsm_det_pointcloud_tpu/datasets/__init__.py, `build_dataloader` :216).

`EpochBatchSampler` gives each epoch's batches of sample indices in the JAX
loader's order (`DataLoader._indices`, :81: an epoch-seeded permutation when
shuffling, then padded to a multiple of the shard count and strided by
rank). Before each sample the dataset's generator, and the legacy global
numpy state, are reseeded from (seed, epoch, index) (`seed_for_sample`, as
the JAX `_seed_for_sample` :198), so the augmentation stream does not depend
on the worker count or on scheduling.

`DataLoader` loads the samples with a `torch.utils.data.DataLoader` whose
workers take one sample at a time (one batch's samples load on all workers
at once; the JAX loader gives a whole batch to one worker) and collates them
in the calling process. Workers fork from a fork server, not from the
caller: by the time the loader starts, the caller has initialised CUDA and
run torch's and the host library's OpenMP pools, and a forked child of such
a process can deadlock in libgomp. The fork server imports torch and this
package before it forks any worker, and passes on one thread for numpy
and OpenMP (`_WORKER_ENV`). The dataset goes to each worker by pickle, once
(`persistent_workers`), and must hold no CUDA tensor. A sample that takes
over `timeout` seconds fails the pass instead of hanging it. Batches come
back as `to_torch_batch` makes them: numeric arrays as CPU tensors (pinned
when `pin_memory`), `frame_id`, `calib`, `image_shape` and the other host
entries as they are. `close()` stops a loader's workers and waits for them;
`stop_workers()`, which also runs at exit once a loader has started workers,
closes every loader, then stops the fork server and multiprocessing's
resource tracker and waits for each, so a program that ran a loader leaves
no process behind (the fork server, left to notice its caller's exit, tears
down its torch import for about a second after). `forkserver_context()`
gives that fork server to other process pools (`create_waymo_infos`).

Every dataset of the JAX registry is ported: `KittiDataset`,
`WaymoDataset`, `NuScenesDataset`, `LyftDataset` and `PandasetDataset`; an
unknown DATASET name raises. PandaSet's frames are pandas pickles: its module
imports pandas where it reads or writes one, so this package imports
without it.
"""
from __future__ import annotations

import atexit
import gc
import multiprocessing
import os
import weakref
from multiprocessing import forkserver, resource_tracker

import numpy as np
import torch

from .dataset import DatasetTemplate
from .kitti.kitti_dataset import KittiDataset
from .lyft.lyft_dataset import LyftDataset
from .nuscenes.nuscenes_dataset import NuScenesDataset
from .pandaset.pandaset_dataset import PandasetDataset
from .waymo.waymo_dataset import WaymoDataset

__all__ = {
    "DatasetTemplate": DatasetTemplate,
    "KittiDataset": KittiDataset,
    "WaymoDataset": WaymoDataset,
    "NuScenesDataset": NuScenesDataset,
    "LyftDataset": LyftDataset,
    "PandasetDataset": PandasetDataset,
}
# batch entries that stay on the host (the JAX device_batch / the
# reference's load_data_to_gpu skip them too, image_shape aside), PandaSet's
# frame keys and pose among them: they go back to generate_prediction_dicts
# as the collate made them (the pose and zrot_world_to_ego float64: world
# coordinates hundreds of metres out lose ~1e-4 m in float32)
HOST_KEYS = ("frame_id", "metadata", "calib", "image_shape", "use_lead_xyz", "batch_size",
             "sequence", "frame_idx", "pose", "zrot_world_to_ego")


def seed_for_sample(ds, seed, epoch, index):
    """Reseed the dataset's generator (the pipeline's RNG) and the legacy
    global numpy state for sample `index` of `epoch`."""
    ss = np.random.SeedSequence([seed, epoch, index])
    ds.rng = np.random.default_rng(ss)
    np.random.seed(ss.generate_state(1)[0])


def load_batch(dataset, indices, seed, epoch):
    """The collated numpy batch of `indices`, each sample reseeded first."""
    samples = []
    for i in indices:
        seed_for_sample(dataset, seed, epoch, int(i))
        samples.append(dataset[int(i)])
    return dataset.collate_batch(samples)


def to_torch_batch(batch):
    """Numeric numpy arrays -> CPU tensors; HOST_KEYS and anything else
    untouched."""
    out = {}
    for k, v in batch.items():
        if (k not in HOST_KEYS and isinstance(v, np.ndarray)
                and v.dtype.kind in "biuf"):
            out[k] = torch.from_numpy(v)
        else:
            out[k] = v
    return out


def load_data_to_device(batch, device):
    """A loader batch on `device`: its tensors copied (non_blocking: from
    pinned memory the copy overlaps the host), the host entries as they
    are."""
    return {k: (v.to(device, non_blocking=True) if isinstance(v, torch.Tensor) else v)
            for k, v in batch.items()}


class EpochBatchSampler:
    """The batches of sample indices of one epoch, in the order of the JAX
    loader's `_indices`: shuffled by an epoch-seeded permutation when
    `shuffle`, then padded to a multiple of `num_shards` and taken every
    `num_shards`-th from `shard_id`."""

    def __init__(self, n, batch_size, shuffle=False, drop_last=False, seed=0,
                 num_shards=1, shard_id=0):
        self.n = n
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.num_shards = num_shards
        self.shard_id = shard_id
        self.epoch = 0

    def set_epoch(self, epoch):
        self.epoch = epoch

    def indices(self):
        n = self.n
        if self.shuffle:
            g = np.random.default_rng(np.random.SeedSequence([self.seed, self.epoch]))
            idx = g.permutation(n)
        else:
            idx = np.arange(n)
        if self.num_shards > 1:
            total = -(-n // self.num_shards) * self.num_shards
            idx = np.concatenate([idx, idx[: total - n]])
            idx = idx[self.shard_id :: self.num_shards]
        return idx

    def batches(self):
        idx = self.indices()
        out = [idx[i : i + self.batch_size] for i in range(0, len(idx), self.batch_size)]
        if self.drop_last:
            out = [b for b in out if len(b) == self.batch_size]
        return out

    def __len__(self):
        per_shard = len(self.indices())
        if self.drop_last:
            return per_shard // self.batch_size
        return -(-per_shard // self.batch_size)


class _SampleOrder(torch.utils.data.Sampler):
    """(epoch, index) of every sample of the epoch's batches, in order."""

    def __init__(self, batches):
        self.batches = batches

    def __iter__(self):
        for b in self.batches.batches():
            for i in b:
                yield self.batches.epoch, int(i)

    def __len__(self):
        return sum(len(b) for b in self.batches.batches())


class _SampleLoad(torch.utils.data.Dataset):
    """(epoch, index) -> the sample, its generator reseeded first."""

    def __init__(self, dataset, seed):
        self.dataset = dataset
        self.seed = seed

    def __getitem__(self, item):
        epoch, index = item
        seed_for_sample(self.dataset, self.seed, epoch, index)
        return self.dataset[index]


def _whole(sample):
    return sample


# a worker's numpy (BLAS) and host library (OpenMP) run on one thread: with
# pools of all the cores in each of 4 workers beside the training process, a
# sample took twice as long
_WORKER_ENV = {"OMP_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}
# the loaders whose workers may be running
_STARTED = weakref.WeakSet()


def forkserver_context():
    """multiprocessing's forkserver context with its server running: the
    server imports torch and this package once, so a process forked from it
    only unpickles its work (a spawned one imports torch itself, and torch
    starts a loader's workers one after another: ~6 s each on the card's
    host), and runs numpy and OpenMP on one thread (`_WORKER_ENV`).
    `stop_workers` stops the server, also at exit."""
    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload(["torch", __name__])
    saved = {k: os.environ.get(k) for k in _WORKER_ENV}
    os.environ.update(_WORKER_ENV)   # the server's environment, and so its children's
    try:
        forkserver.ensure_running()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    atexit.unregister(stop_workers)
    atexit.register(stop_workers)   # runs before torch's and multiprocessing's
    return ctx


def stop_workers():
    """Close every loader's workers, then stop the fork server they fork
    from and multiprocessing's resource tracker (where this process started
    it), waiting for each to exit. A later loader starts them anew."""
    for loader in list(_STARTED):
        loader.close()
    gc.collect()   # the closed queues' semaphores unregister before the tracker stops
    forkserver._forkserver._stop()
    # a spawned process shares its parent's tracker (its pid unknown here):
    # only the process that started a tracker stops it
    if resource_tracker._resource_tracker._pid is not None:
        resource_tracker._resource_tracker._stop()


class DataLoader:
    """The loader of `build_dataloader`: an iterable of collated batches
    (`to_torch_batch`, pinned when `pin_memory`), `len()` batches a pass;
    `set_epoch(e)` picks the epoch whose order and augmentation stream the
    next pass yields, and `start()` starts the workers ahead of the first
    pass (each takes seconds to import torch; they persist across passes
    until `close()`)."""

    def __init__(self, dataset, batch_size, shuffle=False, drop_last=False, seed=0,
                 num_shards=1, shard_id=0, workers=0, pin_memory=False, timeout=600):
        self.dataset = dataset
        self.batch_size = batch_size
        self.pin_memory = pin_memory
        self.sampler = EpochBatchSampler(len(dataset), batch_size, shuffle, drop_last, seed,
                                         num_shards, shard_id)
        kw = {}
        if workers > 0:
            kw = dict(persistent_workers=True, timeout=timeout, prefetch_factor=2 * batch_size)
        self._loader = torch.utils.data.DataLoader(
            _SampleLoad(dataset, seed), batch_size=None, sampler=_SampleOrder(self.sampler),
            num_workers=workers, collate_fn=_whole, **kw)
        self._started = False

    def set_epoch(self, epoch):
        self.sampler.set_epoch(epoch)

    def start(self):
        """Start the workers now (nothing to do without workers)."""
        if self._loader.num_workers > 0 and not self._started:
            self._loader.multiprocessing_context = forkserver_context()
            iter(self._loader)
            _STARTED.add(self)
            self._started = True

    def close(self):
        """Stop the workers and wait for them to exit; a later pass starts
        them anew."""
        it = getattr(self._loader, "_iterator", None)
        if it is not None:
            it._shutdown_workers()
            self._loader._iterator = None
        _STARTED.discard(self)
        self._started = False

    def __len__(self):
        return len(self.sampler)

    def __iter__(self):
        self.start()
        samples = iter(self._loader)
        for b in self.sampler.batches():
            batch = to_torch_batch(self.dataset.collate_batch([next(samples) for _ in b]))
            if self.pin_memory:
                batch = {k: (v.pin_memory() if isinstance(v, torch.Tensor) else v)
                         for k, v in batch.items()}
            yield batch


def build_dataloader(dataset_cfg, class_names, batch_size, root_path=None, workers=4,
                     seed=None, logger=None, training=True, num_shards=1, shard_id=0,
                     pin_memory=False):
    """(dataset, loader, sampler) of the config's dataset: shuffled, with
    the last ragged batch dropped, for training; in order, all of it, for
    eval."""
    name = dataset_cfg.DATASET
    if name not in __all__:
        raise NotImplementedError(f"dataset {name} is not ported")
    from ..ops import host_native

    host_native.load()  # build the host library once, before the workers start
    dataset = __all__[name](dataset_cfg=dataset_cfg, class_names=class_names,
                            root_path=root_path, training=training, logger=logger)
    loader = DataLoader(dataset, batch_size, shuffle=training, drop_last=training,
                        seed=seed or 0, num_shards=num_shards, shard_id=shard_id,
                        workers=workers, pin_memory=pin_memory)
    return dataset, loader, loader.sampler
