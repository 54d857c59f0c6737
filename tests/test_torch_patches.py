"""PyTorch port: patch windows + per-patch normalization against JAX.

Normalized values within 1e-5 (float32 mean/std summed in another
order); finite flags and the replicate edges exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inaspeechsegmenter_tpu.dsp.patches import (gather_normalized_patches,
                                                normalized_windows_ext as
                                                jax_nwe)
from inaspeechsegmenter_tpu_torch.dsp import patches as tp


def _mspec(t_pad=300, seed=0):
    rng = np.random.default_rng(seed)
    m = (rng.standard_normal((t_pad, 24)) * 3 - 5).astype(np.float32)
    m[100:104] = -np.inf          # digital silence rows
    return m


@pytest.mark.parametrize("nmel", [21, 24])
@pytest.mark.parametrize("n_frames", [281, 300, 68])
def test_normalized_windows_ext_matches_jax(nmel, n_frames):
    m = _mspec()
    ref = jax_nwe(jnp.asarray(m), n_frames, nmel)
    got = tp.normalized_windows_ext(torch.from_numpy(m), n_frames, nmel)
    norm_r, fin_r, last_r, lastfin_r, nrows_r = (np.asarray(a) for a in ref)
    norm, fin, last, lastfin, nrows = got
    assert nrows == int(nrows_r)
    np.testing.assert_array_equal(fin.numpy(), fin_r)
    np.testing.assert_array_equal(lastfin.numpy(), lastfin_r)
    assert not fin_r.all() and fin_r.any()
    np.testing.assert_allclose(norm.numpy()[fin_r], norm_r[fin_r],
                               rtol=1e-5, atol=1e-5)
    if lastfin_r[0]:
        np.testing.assert_allclose(last.numpy(), last_r, rtol=1e-5,
                                   atol=1e-5)
    # replicate edge: the 17 front rows are window 0, bit for bit
    n = norm.numpy()
    for j in range(tp.LPAD):
        np.testing.assert_array_equal(n[j], n[tp.LPAD])


def test_frame_patches_follow_replicate_padding():
    """Frame j reads window clip(j-17, 0, n_rows-1): equal to the ext rows
    inside, to window 0 on the left and to the last window on the right."""
    m = torch.from_numpy(_mspec(seed=1))
    n_frames, nmel = 290, 21
    norm_ext, fin_ext, last, last_fin, n_rows = tp.normalized_windows_ext(
        m, n_frames, nmel)
    frames = torch.arange((n_frames + 1) // 2)
    pt, fin = tp.frame_patches(m, frames, n_frames, nmel)
    flat = pt.reshape(len(frames), -1).numpy()
    inside = frames.numpy() <= n_rows + tp.LPAD - 1
    np.testing.assert_array_equal(flat[inside], norm_ext.numpy()[:inside.sum()])
    np.testing.assert_array_equal(fin.numpy()[inside],
                                  fin_ext.numpy()[:inside.sum()])
    assert (~inside).any()
    np.testing.assert_array_equal(
        flat[~inside], np.broadcast_to(last.numpy(), flat[~inside].shape))


def test_frame_patches_match_jax_gather():
    m = _mspec(seed=2)
    n_frames, nmel = 257, 24
    j = np.arange(0, 129, 3)
    ref_p, ref_f = gather_normalized_patches(jnp.asarray(m), jnp.asarray(j),
                                             n_frames, nmel)
    pt, fin = tp.frame_patches(torch.from_numpy(m), torch.from_numpy(j),
                               n_frames, nmel)
    ref_f = np.asarray(ref_f)
    np.testing.assert_array_equal(fin.numpy(), ref_f)
    np.testing.assert_allclose(pt.numpy()[ref_f], np.asarray(ref_p)[ref_f],
                               rtol=1e-5, atol=1e-5)
