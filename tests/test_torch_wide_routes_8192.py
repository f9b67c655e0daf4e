"""tests/test_torch_wide_routes.py's tests at gf3-8192 (2240 used bins,
64-QAM), in a file of their own so that each file's gf3x programs compile
on one worker within its time."""

import pytest

from test_torch_wide_routes import *  # noqa: F401,F403


@pytest.fixture(scope="module")
def band():
    return "gf3-8192"

# the resampler's test is the same at every band: it runs once, in the
# gf3-4096 file
del test_card_clock_offset_resampler_is_band_limited  # noqa: F821
