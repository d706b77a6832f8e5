"""Sequence window generators: the core windowing / masking / flip engine.

Behavioral parity with reference `uplifiting_dataset.py:213-658`, including the
exact RNG discipline — three independent `np.random.default_rng(seed)` streams
(shuffle/camera-pick, stride-shift, mask-stride choice), reset per epoch in
eval mode — so eval windows and masks are bit-identical.

Windowing here is vectorized: the reference slices `video[begin:end:stride]`
and np.pads the out-of-range ends ("edge" or zero padding); that is exactly a
clipped index gather (positions `i + (k - mid) * stride`), with zeros/validity
applied where the position falls outside the video.

Copied from the JAX package's `data/generator.py` (numpy only).
"""

from __future__ import annotations

import numpy as np


class SequenceWindower:
    """Shared window/stride-mask/flip logic and RNG streams."""

    def __init__(self, seq_len, target_frame_rate=50, subsample=1, stride=1,
                 padding_type="zeros", flip_augment=True, in_batch_augment=False,
                 flip_lr_indices=None, mask_stride=None, stride_mask_align_global=False,
                 rand_shift_stride_mask=False, shuffle=True, seed=0, verbose=True):
        self.seq_len = seq_len
        self.subsample = subsample
        self.stride = stride
        self.target_frame_rate = target_frame_rate
        if padding_type == "zeros":
            self.pad_edge = False
        elif padding_type == "copy":
            self.pad_edge = True
        else:
            raise ValueError(f"Padding type not supported: {padding_type}")
        self.flip_augment = flip_augment
        self.in_batch_augment = in_batch_augment
        self.flip_lr_indices = flip_lr_indices
        self.abs_mask_stride = mask_stride
        if self.abs_mask_stride is not None:
            if not isinstance(self.abs_mask_stride, list):
                self.abs_mask_stride = [self.abs_mask_stride]
            for ams in self.abs_mask_stride:
                assert ams >= self.stride and ams % self.stride == 0
        self.stride_mask_align_global = stride_mask_align_global
        self.rand_shift_stride_mask = rand_shift_stride_mask
        if self.rand_shift_stride_mask:
            assert not self.stride_mask_align_global
        self.shuffle = shuffle
        self.seed = seed
        self.rng = np.random.default_rng(seed=seed)
        self.stride_shift_rng = np.random.default_rng(seed=seed)
        self.mask_stride_rng = np.random.default_rng(seed=seed)
        self.verbose = verbose
        if self.flip_augment:
            assert flip_lr_indices is not None

    # -- location table -----------------------------------------------------

    def build_locations(self, sequence_lengths, frame_rates):
        """(num_windows, 4) table of [sequence_idx, center_frame, do_flip, fps].

        With eager flip augmentation (not in-batch), each location is
        duplicated with do_flip=1.
        """
        locations = []
        for s_i, length in enumerate(sequence_lengths):
            positions = np.arange(0, length, self.subsample)
            seq_num = np.full(positions.shape[0], s_i, dtype=positions.dtype)
            fps = np.full(positions.shape[0], frame_rates[s_i], dtype=positions.dtype)
            do_flip = np.zeros(positions.shape[0], dtype=positions.dtype)
            if self.flip_augment and not self.in_batch_augment:
                seq_num = np.concatenate([seq_num, seq_num])
                fps = np.concatenate([fps, fps])
                positions = np.concatenate([positions, positions])
                do_flip = np.concatenate([do_flip, 1 - do_flip])
            locations.append(np.stack([seq_num, positions, do_flip, fps], axis=-1))
        return np.concatenate(locations, axis=0)

    def epoch_locations(self, sequence_locations, reset_camera_rng=False):
        """Per-epoch location order; resets the per-item RNG streams in eval mode."""
        if self.shuffle:
            locs = sequence_locations.copy()
            self.rng.shuffle(locs)
            return locs
        # Deterministic eval: restart the per-item streams each epoch
        if reset_camera_rng:
            self.rng = np.random.default_rng(seed=self.seed)
        self.stride_shift_rng = np.random.default_rng(seed=self.seed)
        self.mask_stride_rng = np.random.default_rng(seed=self.seed)
        return sequence_locations

    # -- per-item sampling ---------------------------------------------------

    def resolve_strides(self, frame_rate):
        """Returns (window stride, absolute mask stride) for a sample.

        Sequences at a multiple of the target frame rate get both strides
        scaled by the multiplier. Draws from `mask_stride_rng` when multiple
        mask-stride values are configured.
        """
        assert frame_rate % self.target_frame_rate == 0
        mult = frame_rate // self.target_frame_rate if frame_rate != self.target_frame_rate else 1
        stride = self.stride * mult

        if self.abs_mask_stride is None:
            abs_mask_stride = stride
        else:
            if len(self.abs_mask_stride) == 1:
                abs_mask_stride = self.abs_mask_stride[0]
            else:
                abs_mask_stride = self.abs_mask_stride[
                    self.mask_stride_rng.integers(low=0, high=len(self.abs_mask_stride),
                                                  endpoint=False)]
            abs_mask_stride *= mult
        return stride, abs_mask_stride

    def window_indices(self, center, video_len, stride):
        """(indices, valid): gather indices for a centered window.

        Out-of-range slots map to the first/last *sampled* in-range frame —
        matching the reference's slice-then-edge-pad (np.pad replicates the
        first/last extracted frame, not frame 0 / frame len-1).
        """
        mid = self.seq_len // 2
        positions = center + (np.arange(self.seq_len) - mid) * stride
        valid = (positions >= 0) & (positions < video_len)
        assert valid.any(), "window entirely outside the video"
        in_range = positions[valid]
        indices = np.where(positions < 0, in_range[0],
                           np.where(positions >= video_len, in_range[-1], positions))
        return indices, valid

    def extract_window(self, video, indices, valid):
        window = video[indices].copy()
        if not self.pad_edge:
            window[~valid] = 0
        return window

    def stride_mask_for(self, center, stride, abs_mask_stride):
        """Boolean (seq_len,) mask, True on frames carrying real input."""
        mid = self.seq_len // 2
        sequence_indices = (np.arange(self.seq_len) - mid) * stride
        if self.stride_mask_align_global:
            # Align on global frame indices (inference protocol)
            sequence_indices = sequence_indices + center
        elif self.rand_shift_stride_mask:
            mask_stride = abs_mask_stride // stride
            max_shift = int(np.ceil((mask_stride - 1) / 2))
            endpoint = mask_stride % 2 != 0
            rand_shift = self.stride_shift_rng.integers(
                low=-max_shift, high=max_shift, endpoint=endpoint)
            sequence_indices = sequence_indices + rand_shift * stride
        return np.equal(sequence_indices % abs_mask_stride, 0)

    def flip_pose(self, sequence):
        """Mirror a pose sequence: joint permutation + x-negation."""
        flipped = sequence[:, self.flip_lr_indices].copy()
        flipped[..., 0] *= -1
        return flipped

    @staticmethod
    def flip_camera_intrinsics(camera):
        """Negate the principal point cx and the first tangential coefficient."""
        camera = camera.copy()
        camera[4] *= -1
        camera[9] *= -1
        return camera


class H36mSequenceGenerator:
    """Windows over (3D, 2D, camera) H36M sequences.

    Yields (seq3d (N,K,3), seq2d (N,K,2), valid mask (N,), camera 11-vec,
    subject id, action id, center index, stride mask (N,)).
    """

    def __init__(self, poses_3d, poses_2d, camera_params, subjects, actions, frame_rates,
                 split, seq_len, target_frame_rate=50, subsample=1, stride=1,
                 padding_type="zeros", flip_augment=True, in_batch_augment=False,
                 flip_lr_indices=None, mask_stride=None, stride_mask_align_global=False,
                 rand_shift_stride_mask=False, shuffle=True, seed=0, verbose=True):
        self.windower = SequenceWindower(
            seq_len=seq_len, target_frame_rate=target_frame_rate, subsample=subsample,
            stride=stride, padding_type=padding_type, flip_augment=flip_augment,
            in_batch_augment=in_batch_augment, flip_lr_indices=flip_lr_indices,
            mask_stride=mask_stride, stride_mask_align_global=stride_mask_align_global,
            rand_shift_stride_mask=rand_shift_stride_mask, shuffle=shuffle, seed=seed,
            verbose=verbose)
        self.split = split
        self.poses_3d = poses_3d
        self.poses_2d = poses_2d
        self.camera_params = camera_params
        self.subjects = subjects
        self.actions = actions
        self.frame_rates = frame_rates
        if verbose:
            print("Generating sequences ...")
        for s_i, video_3d in enumerate(poses_3d):
            assert len(video_3d) == len(poses_2d[s_i])
        self.sequence_locations = self.windower.build_locations(
            [len(v) for v in poses_3d], frame_rates)

    def __len__(self):
        n = len(self.sequence_locations)
        if self.windower.in_batch_augment and self.windower.flip_augment:
            return 2 * n
        return n

    def next_epoch_iterator(self):
        w = self.windower
        locs = w.epoch_locations(self.sequence_locations)
        for (s_i, i, do_flip, frame_rate) in locs:
            s_i, i, frame_rate = int(s_i), int(i), int(frame_rate)
            stride, abs_mask_stride = w.resolve_strides(frame_rate)

            video_3d, video_2d = self.poses_3d[s_i], self.poses_2d[s_i]
            camera = self.camera_params[s_i]
            subject, action = self.subjects[s_i], self.actions[s_i]

            indices, valid = w.window_indices(i, video_3d.shape[0], stride)
            sequence_3d = w.extract_window(video_3d, indices, valid)
            sequence_2d = w.extract_window(video_2d, indices, valid)
            mask = valid.astype(np.float32)
            stride_mask = w.stride_mask_for(i, stride, abs_mask_stride)

            if do_flip == 1.0:
                sequence_3d = w.flip_pose(sequence_3d)
                sequence_2d = w.flip_pose(sequence_2d)
                camera = w.flip_camera_intrinsics(camera)

            yield sequence_3d, sequence_2d, mask, camera, subject, action, i, stride_mask

            if w.in_batch_augment and w.flip_augment:
                yield (w.flip_pose(sequence_3d), w.flip_pose(sequence_2d), mask,
                       w.flip_camera_intrinsics(camera), subject, action, i, stride_mask)


class AMASSSequenceGenerator:
    """Windows over world-space AMASS 3D sequences with a random H36M camera.

    Yields (seq3d world (N,K,3), camera 18-vec [quat 4 | trans 3 | intrinsic 11],
    valid mask (N,), subject id=0, action id=0, center index, stride mask (N,)).
    The camera transform + 2D projection run device-side (`ops/camera.py`).
    """

    def __init__(self, amass_dataset, seq_len, target_frame_rate=50, subsample=1,
                 stride=1, padding_type="zeros", flip_augment=True, in_batch_augment=False,
                 flip_lr_indices=None, mask_stride=None, stride_mask_align_global=False,
                 rand_shift_stride_mask=False, shuffle=True, seed=0, verbose=True,
                 compat_reference_flip_bug=True):
        self.windower = SequenceWindower(
            seq_len=seq_len, target_frame_rate=target_frame_rate, subsample=subsample,
            stride=stride, padding_type=padding_type, flip_augment=flip_augment,
            in_batch_augment=in_batch_augment, flip_lr_indices=flip_lr_indices,
            mask_stride=mask_stride, stride_mask_align_global=stride_mask_align_global,
            rand_shift_stride_mask=rand_shift_stride_mask, shuffle=shuffle, seed=seed,
            verbose=verbose)
        # The reference's eager-flip branch is dead code (`if do_flip is True:`
        # with a np.bool_ is always False, `uplifiting_dataset.py:640`), so the
        # flip-duplicated locations are yielded *unflipped*. The released AMASS
        # pre-trained weights come from that behavior; keep it by default.
        self.compat_reference_flip_bug = compat_reference_flip_bug
        self.split = amass_dataset.split
        if verbose:
            print("Generating sequences ...")

        # Flatten dataset→subject→action
        self.sequences, self.frame_rates = [], []
        for subjects in amass_dataset._data.values():
            for actions in subjects.values():
                for seq in actions.values():
                    self.sequences.append(seq["positions"])
                    self.frame_rates.append(seq.get("frame_rate", 50))

        # All H36M cameras as 18-vectors
        self.cameras = []
        for cams in amass_dataset.cameras().values():
            for cam in cams:
                if "orientation" in cam:
                    self.cameras.append(np.concatenate(
                        [cam["orientation"], cam["translation"], cam["intrinsic"]],
                        axis=0).astype(np.float32))

        self.sequence_locations = self.windower.build_locations(
            [s.shape[0] for s in self.sequences], self.frame_rates)

    def __len__(self):
        n = len(self.sequence_locations)
        if self.windower.in_batch_augment and self.windower.flip_augment:
            return 2 * n
        return n

    def next_epoch_iterator(self):
        w = self.windower
        locs = w.epoch_locations(self.sequence_locations, reset_camera_rng=True)
        subject, action = 0, 0
        for (s_i, i, do_flip, frame_rate) in locs:
            s_i, i, frame_rate = int(s_i), int(i), int(frame_rate)
            stride, abs_mask_stride = w.resolve_strides(frame_rate)

            video = self.sequences[s_i]
            indices, valid = w.window_indices(i, video.shape[0], stride)
            sequence_3d = w.extract_window(video, indices, valid)
            mask = valid.astype(np.float32)
            stride_mask = w.stride_mask_for(i, stride, abs_mask_stride)

            # Random H36M camera per sample; ~2-5% of projections land outside
            # [-1, 1] (accepted — emulates a larger sensor)
            cam = self.cameras[w.rng.integers(low=0, high=len(self.cameras), size=1)[0]]

            if do_flip == 1.0 and not self.compat_reference_flip_bug:
                # Flip only the pose; the camera is left unchanged for AMASS
                sequence_3d = w.flip_pose(sequence_3d)

            yield sequence_3d, cam, mask, subject, action, i, stride_mask

            if w.in_batch_augment and w.flip_augment:
                yield w.flip_pose(sequence_3d), cam, mask, subject, action, i, stride_mask
