from .band import zero_pad_high_freq, zero_pad_low_freq
from .interp import interp_linear, interp_nearest
from .shapes import compute_downsample_rate, token_geometry
from .snake import snake
from .stft import (
    hann_window,
    istft_length,
    stft_num_frames,
    time_to_timefreq,
    timefreq_to_time,
)
from .vq_kernel import nearest_codes_stats, nearest_codes_stats_plain

__all__ = [
    "hann_window",
    "time_to_timefreq",
    "timefreq_to_time",
    "stft_num_frames",
    "istft_length",
    "zero_pad_high_freq",
    "zero_pad_low_freq",
    "interp_linear",
    "interp_nearest",
    "snake",
    "compute_downsample_rate",
    "token_geometry",
    "nearest_codes_stats",
    "nearest_codes_stats_plain",
]
