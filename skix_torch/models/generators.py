"""Training and evaluation batches for the temporal lifter.

A numpy copy of ``skix/models/generators.py``: ``ChunkedGenerator`` (the
reference VideoPose3D ``common/generators.py:11``), receptive-field-padded
2D windows and their 3D target chunks, shuffled, with 50 % horizontal-flip
augmentation (the same seed gives the same batches as skix's, and
``rng_state`` saves and restores the shuffle for a resumed run); and
``UnchunkedGenerator``, whole sequences edge-padded by half the receptive
field for evaluation.
"""

from __future__ import annotations

from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

from skix_torch.geometry.skeletons import H36M_LEFT, H36M_RIGHT


class ChunkedGenerator:
    """Yields ``(batch_2d (B, chunk+rf-1, J, 2), batch_3d (B, chunk, J, 3))``
    from per-clip ``poses_2d (T, J, 2)`` (normalized) and ``poses_3d (T, J,
    3)``; ``chunk_length`` output frames per sample."""

    def __init__(self, poses_2d: Sequence[np.ndarray],
                 poses_3d: Sequence[np.ndarray], receptive_field: int,
                 batch_size: int = 128, chunk_length: int = 1,
                 augment: bool = True, left=H36M_LEFT, right=H36M_RIGHT,
                 left_2d=None, right_2d=None, seed: int = 0):
        assert len(poses_2d) == len(poses_3d)
        self.poses_2d = [np.asarray(p, np.float32) for p in poses_2d]
        self.poses_3d = [np.asarray(p, np.float32) for p in poses_3d]
        self.rf = receptive_field
        self.pad = receptive_field // 2
        self.batch_size = batch_size
        self.chunk = chunk_length
        self.augment = augment
        self.left = list(left)
        self.right = list(right)
        self.left_2d = list(left_2d if left_2d is not None else left)
        self.right_2d = list(right_2d if right_2d is not None else right)
        self.rng = np.random.default_rng(seed)
        pairs = [(ci, s) for ci, p3 in enumerate(self.poses_3d)
                 for s in range(0, p3.shape[0] - chunk_length + 1,
                                chunk_length)]
        self.pairs = np.asarray(pairs, np.int64)

    def __len__(self) -> int:
        return int(np.ceil(len(self.pairs) / self.batch_size))

    @property
    def rng_state(self):
        return self.rng.bit_generator.state

    @rng_state.setter
    def rng_state(self, state):
        self.rng.bit_generator.state = state

    def _window_2d(self, ci: int, start: int) -> np.ndarray:
        p2 = self.poses_2d[ci]
        T = p2.shape[0]
        lo = start - self.pad
        hi = start + self.chunk + self.pad
        lo_c, hi_c = max(lo, 0), min(hi, T)
        w = p2[lo_c:hi_c]
        if lo < 0 or hi > T:            # edge padding
            w = np.pad(w, ((lo_c - lo, hi - hi_c), (0, 0), (0, 0)),
                       mode="edge")
        return w

    def epoch(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        order = self.rng.permutation(len(self.pairs))
        for b in range(len(self)):
            sel = self.pairs[order[b * self.batch_size:
                                   (b + 1) * self.batch_size]]
            xs, ys = [], []
            for ci, s in sel:
                x = self._window_2d(ci, s)
                y = self.poses_3d[ci][s:s + self.chunk]
                if self.augment and self.rng.random() < 0.5:
                    x = x.copy()
                    y = y.copy()
                    x[..., 0] *= -1
                    x[:, self.left_2d + self.right_2d] = \
                        x[:, self.right_2d + self.left_2d]
                    y[..., 0] *= -1
                    y[:, self.left + self.right] = y[:, self.right + self.left]
                xs.append(x)
                ys.append(y)
            yield np.stack(xs), np.stack(ys)


class UnchunkedGenerator:
    """Full-sequence eval batches: yields per-clip ``(padded_2d (1, T + rf
    − 1, J, 2), poses_3d (T, J, 3) or None)``, the 2D sequence edge-padded
    by ``receptive_field // 2`` frames at each end (reference
    generators.py:168)."""

    def __init__(self, poses_2d: Sequence[np.ndarray],
                 poses_3d: Optional[Sequence[np.ndarray]],
                 receptive_field: int):
        self.poses_2d = [np.asarray(p, np.float32) for p in poses_2d]
        self.poses_3d = (None if poses_3d is None
                         else [np.asarray(p, np.float32) for p in poses_3d])
        self.pad = receptive_field // 2

    def __iter__(self):
        for i, p2 in enumerate(self.poses_2d):
            x = np.pad(p2, ((self.pad, self.pad), (0, 0), (0, 0)), mode="edge")
            y = None if self.poses_3d is None else self.poses_3d[i]
            yield x[None], y
