"""Audio mixer: continuous mixing at a fixed sample rate.

Python/numpy re-implementation of the reference audio mixer
(`smelter-core/src/audio_mixer/`): per-tick 20 ms chunks, gap-fill with
silence, per-input volume, SumClip / SumScale (auto-leveling AGC with a
ramped scaling factor, constants from `mixer.rs:91-94`), mono/stereo
downmix, and a per-input resampler with drift correction (gap-fill /
stretch(+4%) / on-time / squash(-4%) / drop branches, `input/resampler.rs`).

Samples are float64 numpy arrays shaped (n, 2) internally (stereo planar
pairs); mono inputs upmix by duplication, mono outputs average channels.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from smelter_tpu_torch.core.types import AudioSamples

VOL_DOWN_THRESHOLD = 1.0
VOL_UP_THRESHOLD = 0.7
VOL_DOWN_INCREMENT = 0.02
VOL_UP_INCREMENT = 0.01
MAX_STRETCH_RATIO = 0.04


@dataclass
class AudioMixerInputConfig:
    input_id: str
    volume: float = 1.0


@dataclass
class AudioMixerConfig:
    inputs: List[AudioMixerInputConfig] = field(default_factory=list)
    mixing_strategy: str = "sum_clip"  # sum_clip | sum_scale
    channels: str = "stereo"  # stereo | mono


def _to_stereo(samples: np.ndarray) -> np.ndarray:
    if samples.ndim == 1:
        samples = samples[:, None]
    if samples.shape[1] == 1:
        return np.repeat(samples, 2, axis=1)
    return samples[:, :2]


# Windowed-sinc interpolator geometry: 16 taps (8 each side), Kaiser beta 8.
# Matches the reference's rubato `SincFixedOut`-class quality
# (`audio_mixer/input/resampler.rs:21-70`) without a per-input native context.
_SINC_HALF = 8
_SINC_TAPS = 2 * _SINC_HALF
_KAISER_BETA = 8.0
_KAISER_I0_BETA = float(np.i0(_KAISER_BETA))


def _sinc_weights(frac: np.ndarray, step: float) -> np.ndarray:
    """(n,) fractional positions -> (n, taps) Kaiser-windowed sinc weights.

    ``step`` is input frames consumed per output frame; when > 1
    (downsampling) the sinc cutoff scales to the output Nyquist so imaging
    folds below the passband instead of aliasing into it."""
    k = np.arange(-_SINC_HALF + 1, _SINC_HALF + 1, dtype=np.float64)
    x = k[None, :] - frac[:, None]  # offset of each tap from the sample point
    cutoff = min(1.0, 1.0 / step) * 0.945
    h = cutoff * np.sinc(cutoff * x)
    t = x / _SINC_HALF
    inside = np.abs(t) < 1.0
    w = np.where(inside, np.i0(_KAISER_BETA * np.sqrt(np.clip(1.0 - t * t, 0.0, 1.0))), 0.0)
    h = h * (w / _KAISER_I0_BETA)
    # unity DC gain per output sample (kills sub-LSB passband ripple)
    return h / h.sum(axis=1, keepdims=True)


class InputResampler:
    """Drift-corrected per-input resampler.

    Keeps an input-side PCM buffer with a PTS watermark; every `get_samples`
    call compares where the next output sample *should* land vs where the
    buffered input actually starts and picks one of the reference's five
    branches (gap-fill / stretch / on-time / squash / drop). Resampling uses
    Kaiser-windowed sinc interpolation at a dynamically adjusted ratio with
    phase continuity across chunks (reference quality anchor: rubato sinc,
    `audio_mixer/input/resampler.rs`)."""

    def __init__(self, input_rate: int, output_rate: int) -> None:
        self.input_rate = input_rate
        self.output_rate = output_rate
        self.buffer = np.zeros((0, 2), np.float64)
        self.buffer_end_pts: Optional[float] = None
        self.started = False
        # last taps input frames already consumed (left context for the sinc
        # kernel) + fractional read position carried across chunks
        self._hist = np.zeros((_SINC_TAPS, 2), np.float64)
        self._phase = 0.0
        self._aligned = False

    def write_batch(self, batch: AudioSamples, input_rate: int) -> None:
        if input_rate != self.input_rate:
            # sample-rate change: rebuild (reference InputProcessor behavior)
            self.input_rate = input_rate
            self.buffer = np.zeros((0, 2), np.float64)
            self.buffer_end_pts = None
            self._hist = np.zeros((_SINC_TAPS, 2), np.float64)
            self._phase = 0.0
            self._aligned = False
        samples = _to_stereo(np.asarray(batch.samples, np.float64))
        start = batch.start_pts
        dur = len(samples) / self.input_rate
        if self.buffer_end_pts is None:
            self.buffer = samples
            self.buffer_end_pts = start + dur
            return
        # drop overlap with what we already buffered
        overlap = self.buffer_end_pts - start
        if overlap > 0:
            skip = int(round(overlap * self.input_rate))
            samples = samples[skip:]
        if len(samples):
            self.buffer = np.concatenate([self.buffer, samples])
            self.buffer_end_pts = start + dur
        self.started = True

    def _buffer_start_pts(self) -> Optional[float]:
        if self.buffer_end_pts is None:
            return None
        return self.buffer_end_pts - len(self.buffer) / self.input_rate

    def get_samples(self, pts_range: Tuple[float, float]) -> Optional[np.ndarray]:
        """Return exactly the output frames covering pts_range (zero-padded),
        or None if this input produced nothing yet."""
        start, end = pts_range
        n_out = int(round((end - start) * self.output_rate))
        buf_start = self._buffer_start_pts()
        if buf_start is None:
            return None
        ratio = 1.0
        # drift > 0: buffered input starts later than requested (input behind
        # schedule -> missing data); drift < 0: stale input to discard.
        drift = buf_start - start
        dead_band = 2.0 / self.output_rate
        if buf_start >= end:
            # input entirely in the future of this chunk: pure silence
            return np.zeros((n_out, 2), np.float64)
        if not self._aligned:
            # fresh stream: align EXACTLY to the first served request —
            # drain the stale prefix / zero-fill the gap instead of slewing
            # (reference equal_sample_rate_tests.rs "fresh" semantics; the
            # drift branches below only correct drift that develops later)
            if drift < 0:
                excess = int(round(-drift * self.input_rate))
                self.buffer = self.buffer[excess:]
            elif drift > 0:
                missing = int(round(drift * self.input_rate))
                self.buffer = np.concatenate(
                    [np.zeros((missing, 2), np.float64), self.buffer]
                )
            self._aligned = True
            drift = 0.0
        if drift > 0.02:
            # gap-fill: prepend zeros covering [start, buf_start)
            missing = int(round(drift * self.input_rate))
            self.buffer = np.concatenate(
                [np.zeros((missing, 2), np.float64), self.buffer]
            )
        elif drift > dead_band:
            # slightly behind: stretch (consume less input per output frame)
            ratio = 1.0 + min(drift * 10.0, MAX_STRETCH_RATIO)
        elif drift < -0.02:
            # far ahead: drop stale input
            excess = int(round(-drift * self.input_rate))
            self.buffer = self.buffer[excess:]
        elif drift < -dead_band:
            # slightly ahead: squash (consume more input per output frame)
            ratio = 1.0 - min(-drift * 10.0, MAX_STRETCH_RATIO)

        # input frames consumed per output frame
        step = self.input_rate / (self.output_rate * ratio)
        if abs(step - 1.0) < 1e-12 and self._phase < 1e-9:
            # bit-exact pass-through (common case: on-time, same rate)
            chunk = self.buffer[:n_out]
            self.buffer = self.buffer[n_out:]
            if len(chunk) < n_out:
                chunk = np.concatenate(
                    [chunk, np.zeros((n_out - len(chunk), 2), np.float64)]
                )
            self._hist = np.concatenate([self._hist, chunk])[-_SINC_TAPS:]
            return chunk

        # windowed-sinc interpolation with phase carried across chunks
        src_pos = self._phase + np.arange(n_out, dtype=np.float64) * step
        base = np.floor(src_pos).astype(np.int64)
        n_need = int(base[-1]) + _SINC_HALF + 1
        chunk = self.buffer[:n_need]
        if len(chunk) < n_need:
            chunk = np.concatenate(
                [chunk, np.zeros((n_need - len(chunk), 2), np.float64)]
            )
        full = np.concatenate([self._hist, chunk])
        k = np.arange(-_SINC_HALF + 1, _SINC_HALF + 1, dtype=np.int64)
        idx = base[:, None] + k[None, :] + _SINC_TAPS  # (n_out, taps), >= 0
        weights = _sinc_weights(src_pos - base, step)
        out = (full[idx] * weights[..., None]).sum(axis=1)

        end_pos = self._phase + n_out * step
        consumed = int(math.floor(end_pos))
        self._phase = end_pos - consumed
        self._hist = full[consumed : consumed + _SINC_TAPS]
        self.buffer = self.buffer[consumed:]
        return out


class SampleMixer:
    """Sum + clip/AGC-scale (reference `audio_mixer/mix.rs`)."""

    def __init__(self) -> None:
        self.scaling_factor = 1.0

    def sum_samples(
        self,
        input_samples: Dict[str, np.ndarray],
        samples_count: int,
        inputs: List[AudioMixerInputConfig],
    ) -> np.ndarray:
        acc = np.zeros((samples_count, 2), np.float64)
        for cfg in inputs:
            samples = input_samples.get(cfg.input_id)
            if samples is None:
                continue
            n = min(len(samples), samples_count)
            acc[:n] += samples[:n] * cfg.volume
        return acc

    def mix(
        self,
        input_samples: Dict[str, np.ndarray],
        config: AudioMixerConfig,
        samples_count: int,
    ) -> np.ndarray:
        from smelter_tpu_torch.utils import tracing

        with tracing.span("audio.mix"):
            return self._mix(input_samples, config, samples_count)

    def _mix(
        self,
        input_samples: Dict[str, np.ndarray],
        config: AudioMixerConfig,
        samples_count: int,
    ) -> np.ndarray:
        summed = self.sum_samples(input_samples, samples_count, config.inputs)
        if config.mixing_strategy == "sum_scale":
            mixed = self._scale(summed)
        else:
            mixed = np.clip(summed, -1.0, 1.0)
        if config.channels == "mono":
            return mixed.mean(axis=1, keepdims=True)
        return mixed

    def _scale(self, summed: np.ndarray) -> np.ndarray:
        if len(summed) == 0:
            return summed
        max_sample = float(np.abs(summed).max())
        old = self.scaling_factor
        if max_sample * old > VOL_DOWN_THRESHOLD:
            self.scaling_factor = max(old - VOL_DOWN_INCREMENT, 0.0)
        elif max_sample * old < VOL_UP_THRESHOLD:
            self.scaling_factor = min(old + VOL_UP_INCREMENT, 1.0)
        # ramp the factor across the chunk to avoid zipper noise
        factors = old + (self.scaling_factor - old) * (
            np.arange(len(summed)) / len(summed)
        )
        return np.clip(summed * factors[:, None], -1.0, 1.0)


class AudioMixer:
    """Owns per-input resamplers and per-output mixing configs.

    `process_batch_set` contract (reference `mixer.rs:17-39`): called with
    every queue audio batch in PTS order; gaps between batch sets are filled
    with silence; each input batch is delivered exactly once.
    """

    def __init__(self, mixing_sample_rate: int = 48000) -> None:
        self.mixing_sample_rate = mixing_sample_rate
        self.inputs: Dict[str, InputResampler] = {}
        self.input_rates: Dict[str, int] = {}
        self.outputs: Dict[str, AudioMixerConfig] = {}
        self.sample_mixer = SampleMixer()
        self.last_end: Optional[float] = None

    def register_input(self, input_id: str, sample_rate: Optional[int] = None):
        self.inputs[input_id] = InputResampler(
            sample_rate or self.mixing_sample_rate, self.mixing_sample_rate
        )
        self.input_rates[input_id] = sample_rate or self.mixing_sample_rate

    def unregister_input(self, input_id: str) -> None:
        self.inputs.pop(input_id, None)
        self.input_rates.pop(input_id, None)

    def register_output(self, output_id: str, config: AudioMixerConfig) -> None:
        self.outputs[output_id] = config

    def update_output(self, output_id: str, config: AudioMixerConfig) -> None:
        if output_id not in self.outputs:
            raise KeyError(f"output {output_id!r} not registered")
        self.outputs[output_id] = config

    def unregister_output(self, output_id: str) -> None:
        self.outputs.pop(output_id, None)

    def process_batch_set(
        self,
        start_pts: float,
        end_pts: float,
        samples: Dict[str, List[AudioSamples]],
        input_rates: Optional[Dict[str, int]] = None,
    ) -> Dict[str, Tuple[np.ndarray, float]]:
        """Mix one chunk; returns {output_id: (samples (n, ch) f64, pts)}.
        Prepends gap silence if a PTS gap is detected."""
        if self.last_end is None:
            self.last_end = start_pts
        gap_out: Dict[str, np.ndarray] = {}
        gap_pts = self.last_end
        if self.last_end < start_pts - 1e-9:
            missing = int(
                math.floor((start_pts - self.last_end) * self.mixing_sample_rate)
            )
            if missing > 0:
                for oid, cfg in self.outputs.items():
                    gap_out[oid] = self.sample_mixer.mix({}, cfg, missing)

        for input_id, batches in samples.items():
            resampler = self.inputs.get(input_id)
            if resampler is None:
                continue
            rate = (input_rates or {}).get(
                input_id, self.input_rates.get(input_id, self.mixing_sample_rate)
            )
            for batch in batches:
                resampler.write_batch(batch, rate)

        pts_range = (start_pts, end_pts)
        input_samples: Dict[str, np.ndarray] = {}
        for input_id, resampler in self.inputs.items():
            out = resampler.get_samples(pts_range)
            if out is not None:
                input_samples[input_id] = out

        count = int(round((end_pts - start_pts) * self.mixing_sample_rate))
        result: Dict[str, Tuple[np.ndarray, float]] = {}
        for oid, cfg in self.outputs.items():
            mixed = self.sample_mixer.mix(input_samples, cfg, count)
            if oid in gap_out:
                mixed = np.concatenate([gap_out[oid], mixed])
                result[oid] = (mixed, gap_pts)
            else:
                result[oid] = (mixed, start_pts)
        self.last_end = end_pts
        return result
