"""The sky table that the benchmark hands to the program and the reference:
built one band of rows of one face at a time, it equals the former build of
the whole (6,S,S) table in one expression, bit for bit."""

import pytest
import torch

from portbench import inputs


def whole_table_sky(s: int) -> torch.Tensor:
    """The former make_sky: every face and texel in one expression, with
    (6,S,S) int32 temporaries."""
    ar = torch.arange(s, dtype=torch.int32)
    yy, xx = torch.meshgrid(ar, ar, indexing="ij")
    check = (yy // 4 + xx // 4) % 2
    blue = (xx * 255) // max(s - 1, 1)
    face = torch.arange(6, dtype=torch.int32)[:, None, None]
    red = torch.clamp(40 * face + 55 + 120 * check, 0, 255)
    green = torch.clamp(255 - 30 * face - 100 * check, 0, 255)
    return ((red << 16) | (green << 8) | blue).reshape(-1).contiguous()


@pytest.mark.parametrize("size", [1, 5, 64, 2048])
def test_sliced_sky_equals_the_whole_table_build(size):
    got = inputs.make_sky({"kind": "checker", "size": size}, "cpu")
    assert got.dtype == torch.int32 and got.shape == (6 * size * size,)
    assert got.is_contiguous()
    assert torch.equal(got, whole_table_sky(size))


@pytest.mark.parametrize("rows", [1, 3, 64, 100])
def test_band_height_does_not_change_the_table(monkeypatch, rows):
    """Bands that divide the face and bands that leave a short last one."""
    monkeypatch.setattr(inputs, "SKY_ROWS", rows)
    got = inputs.make_sky({"kind": "checker", "size": 64}, "cpu")
    assert torch.equal(got, whole_table_sky(64))


def test_unknown_sky_kind_is_refused():
    with pytest.raises(ValueError):
        inputs.make_sky({"kind": "jpeg", "size": 4}, "cpu")
