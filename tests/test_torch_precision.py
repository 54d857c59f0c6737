"""PyTorch port: the ``ISS_CNN_PRECISION`` / ``ISS_XVEC_PRECISION`` ladders
and ``ISS_XVEC_TAIL`` against the JAX package, on the CPU.

The port's tiers take the JAX package's values, each mapped to the card's
counterpart (HIGHEST -> ``highest``, HIGH -> ``high`` (TF32), DEFAULT ->
``bf16``), and reject others with a ``ValueError`` naming the variable;
an empty value means the default.  JAX's DEFAULT still computes in f32 on
the CPU while the port's ``bf16`` runs bf16 there too, so ``bf16`` is held
to the JAX CPU output within 2e-2 (CNN probabilities) and 5e-2 (relative
L2 of embeddings).  TF32 does not exist on the CPU: ``high`` equals
``highest`` bit for bit here.  A forward leaves the process's TF32 flags
as it found them; a scope on one thread waits for another thread's scope
to end; the VBx features run at ``highest`` whatever the process's flags.
"""

import threading
import time

import jax
import numpy as np
import pytest
import torch

from inaspeechsegmenter_tpu import vfs as jvfs
from inaspeechsegmenter_tpu.models import layers as jl
from inaspeechsegmenter_tpu.models import resnet as jres
from inaspeechsegmenter_tpu.models import synthetic as jsyn
from inaspeechsegmenter_tpu.models.keras_h5 import ImportedModel as JaxModel
from inaspeechsegmenter_tpu_torch import vfs as tvfs
from inaspeechsegmenter_tpu_torch.models import layers as tl
from inaspeechsegmenter_tpu_torch.models import resnet as tres
from inaspeechsegmenter_tpu_torch.models.native import ImportedModel

TINY = ("bottleneck", (1, 1, 1, 1), 8, 64, 256)
JAX_TO_TIER = {jax.lax.Precision.HIGHEST: "highest",
               jax.lax.Precision.HIGH: "high",
               jax.lax.Precision.DEFAULT: "bf16"}
LADDERS = [("ISS_CNN_PRECISION", jl._PRECISIONS, tl.CNN_TIERS,
            tl.cnn_precision),
           ("ISS_XVEC_PRECISION", jres._XPREC, tres.XVEC_TIERS,
            tres.xvec_precision)]


@pytest.mark.parametrize("env,jax_table,table,read", LADDERS,
                         ids=["cnn", "xvec"])
def test_ladder_values_and_errors(monkeypatch, env, jax_table, table, read):
    assert set(table) == set(jax_table)
    for value, prec in jax_table.items():
        assert table[value] == JAX_TO_TIER[prec]
        monkeypatch.setenv(env, value.upper())
        assert read() == JAX_TO_TIER[prec]
    for empty in ("", None):
        if empty is None:
            monkeypatch.delenv(env)
        else:
            monkeypatch.setenv(env, empty)
        assert read() == "highest"
    monkeypatch.setenv(env, "fp8")
    with pytest.raises(ValueError, match=env):
        read()


@pytest.fixture(scope="module")
def cnn():
    spec, params = jsyn.build_patch_cnn(21, 3, seed=2, size="small")
    rng = np.random.default_rng(2)
    x = rng.standard_normal((32, 68, 21, 1)).astype(np.float32)
    return spec, params, x


def _run(model, x):
    with torch.no_grad():
        return model(torch.from_numpy(x)).numpy()


def test_cnn_tiers_on_the_cpu(cnn, monkeypatch):
    spec, params, x = cnn
    want = np.asarray(JaxModel(spec, params)(x))
    outs = {}
    for tier in ("highest", "high", "bf16"):
        monkeypatch.setenv("ISS_CNN_PRECISION", tier)
        model = ImportedModel(spec, params)
        assert model.precision == tier
        low = [m.weight_bf16 for m in model.modules()
               if isinstance(m, tl._Weighted)]
        assert all((w is not None) == (tier == "bf16") for w in low)
        outs[tier] = _run(model, x)
    np.testing.assert_array_equal(outs["high"], outs["highest"])
    np.testing.assert_allclose(outs["highest"], want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(outs["bf16"], want, rtol=0, atol=2e-2)
    assert not np.array_equal(outs["bf16"], outs["highest"])
    assert outs["bf16"].dtype == np.float32


@pytest.fixture(scope="module")
def xparams():
    return jres.ResNetXVector(*TINY).init_params(seed=3)


def _rel_l2(a, b):
    return float((np.linalg.norm(a - b, axis=1)
                  / np.linalg.norm(b, axis=1)).max())


def test_xvec_tiers_on_the_cpu(xparams, monkeypatch):
    x = np.random.default_rng(4).standard_normal(
        (4, 64, 144)).astype(np.float32)
    want = np.asarray(jres.ResNetXVector(*TINY)(xparams, x))
    outs = {}
    for tier in ("highest", "high", "fast"):
        monkeypatch.setenv("ISS_XVEC_PRECISION", tier)
        net = tres.ResNetXVector(*TINY).load_jax_params(xparams)
        outs[tier] = _run(net, x)
        if tier == "fast":
            # the bf16 copies follow the loaded weights
            assert net.precision == "bf16"
            assert torch.equal(net.conv1.weight_bf16,
                               net.conv1.weight.to(torch.bfloat16))
    np.testing.assert_array_equal(outs["high"], outs["highest"])
    assert _rel_l2(outs["highest"], want) <= 1e-4
    assert _rel_l2(outs["fast"], want) <= 5e-2
    assert not np.array_equal(outs["fast"], outs["highest"])


@pytest.mark.parametrize("matmul,cudnn", [(False, False), (True, True),
                                          (True, False)])
def test_forward_restores_tf32_flags(cnn, xparams, monkeypatch, matmul,
                                     cudnn):
    """Each forward sets its tier's flags for itself (seen from inside by a
    hook) and restores the process's flags."""
    spec, params, x = cnn
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", matmul)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", cudnn)
    seen = []

    def hook(*_):
        seen.append((torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32))

    for tier in ("high", "highest"):
        monkeypatch.setenv("ISS_CNN_PRECISION", tier)
        model = ImportedModel(spec, params)
        model.layers[0].register_forward_hook(hook)
        _run(model, x[:2])
        net = tres.ResNetXVector(*TINY).load_jax_params(xparams)
        net.set_precision(tier).layer1[0].register_forward_hook(hook)
        _run(net, np.zeros((1, 64, 50), np.float32))
        assert (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32) == (matmul, cudnn)
    assert seen == [(True, True)] * 2 + [(False, False)] * 2


def test_exact_tail_matches_jax(xparams, monkeypatch):
    """``ISS_XVEC_TAIL=exact`` embeds the tail window at its own length;
    the default masked tail agrees with it up to float reassociation."""
    monkeypatch.setenv("ISS_VFS_OVERLAP", "0")
    fea = np.random.default_rng(5).standard_normal(
        (200, 64)).astype(np.float32)
    duration = (199 * 160 + 80) / 16000
    tails = {}
    for mode in ("exact", "masked"):
        monkeypatch.setenv("ISS_XVEC_TAIL", mode)
        want = jvfs.JaxResnetExtractor(params=xparams, net=jres.ResNetXVector(
            *TINY))("f", fea, duration)
        got = tvfs.TorchResnetExtractor(xparams, tres.ResNetXVector(*TINY),
                                        "cpu")("f", torch.from_numpy(fea),
                                               duration)
        assert [(k, s) for k, s, _ in got] == [(k, s) for k, s, _ in want]
        assert got[-1][0] == "f_00000072-00000200"      # the tail window
        assert _rel_l2(got[-1][2][None], want[-1][2][None]) <= 1e-4
        tails[mode] = got[-1][2]
    assert _rel_l2(tails["masked"][None], tails["exact"][None]) <= 1e-4


def test_scopes_on_two_threads_do_not_interleave(monkeypatch):
    """A scope entered on another thread waits until this one has ended,
    so neither runs under the other's flags, and the flags end as they
    began."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    entered, release = threading.Event(), threading.Event()
    seen = []

    def other():
        entered.wait()
        with tl.precision_scope("highest"):
            seen.append(("other", torch.backends.cuda.matmul.allow_tf32,
                         torch.backends.cudnn.allow_tf32))

    worker = threading.Thread(target=other)
    worker.start()
    with tl.precision_scope("high"):
        entered.set()
        worker.join(timeout=0.2)
        assert worker.is_alive()            # held back by this scope
        with tl.precision_scope("highest"):  # re-entered on one thread
            seen.append(("nested", torch.backends.cuda.matmul.allow_tf32,
                         torch.backends.cudnn.allow_tf32))
        seen.append(("high", torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32))
    worker.join(timeout=10)
    assert not worker.is_alive()
    assert seen == [("nested", False, False), ("high", True, True),
                    ("other", False, False)]
    assert (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32) == (False, True)


def test_scopes_at_one_tier_overlap(monkeypatch):
    """Two threads at one tier are inside their scopes at once (the
    engine's slots), under that tier's flags; the flags end as they
    began."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    both = threading.Barrier(2, timeout=10)
    seen = []

    def slot():
        with tl.precision_scope("highest"):
            both.wait()                 # raises if the other is held back
            seen.append((torch.backends.cuda.matmul.allow_tf32,
                         torch.backends.cudnn.allow_tf32))
            both.wait()

    workers = [threading.Thread(target=slot) for _ in range(2)]
    for w in workers:
        w.start()
    for w in workers:
        w.join(timeout=20)
    assert seen == [(False, False)] * 2
    assert (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32) == (True, True)


def test_scopes_at_two_tiers_never_overlap(monkeypatch):
    """Threads at two tiers, many entries each: a scope never runs while a
    scope of the other tier is inside, always under its own tier's flags,
    and both tiers got in (neither was starved)."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    guard = threading.Lock()
    inside = {"high": 0, "highest": 0}
    faults, entries = [], {"high": 0, "highest": 0}

    def run(tier, other):
        for _ in range(150):
            with tl.precision_scope(tier):
                with guard:
                    inside[tier] += 1
                    entries[tier] += 1
                    if inside[other]:
                        faults.append("overlap")
                if torch.backends.cuda.matmul.allow_tf32 != (tier == "high"):
                    faults.append("flags")
                time.sleep(0.0002)
                with guard:
                    inside[tier] -= 1

    workers = [threading.Thread(target=run, args=(t, o)) for t, o in
               [("high", "highest"), ("highest", "high")] * 3]
    for w in workers:
        w.start()
    for w in workers:
        w.join(timeout=60)
    assert not any(w.is_alive() for w in workers)
    assert faults == [] and entries == {"high": 450, "highest": 450}
    assert (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32) == (False, True)


def test_vbx_features_run_at_highest(monkeypatch):
    """The VBx DFT and filter-bank matmuls run with TF32 off even when the
    process has it on, and the flags are restored after."""
    from inaspeechsegmenter_tpu_torch.dsp.vbx import VbxFrontend

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    fe = VbxFrontend("cpu")
    log_fbank, seen = fe._log_fbank, []

    def spy(seg):
        seen.append((torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32))
        return log_fbank(seg)

    monkeypatch.setattr(fe, "_log_fbank", spy)
    signal = np.random.default_rng(6).uniform(-0.5, 0.5, 16000)
    assert fe.features(signal).shape == (100, 64)
    assert seen == [(False, False)]
    assert (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32) == (True, True)
