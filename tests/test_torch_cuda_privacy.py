# Copyright 2026 The rayfed-tpu Authors.
#
# Licensed under the Apache License, Version 2.0 (the "License");
# you may not use this file except in compliance with the License.
# You may obtain a copy of the License at
#
#     http://www.apache.org/licenses/LICENSE-2.0
#
# Unless required by applicable law or agreed to in writing, software
# distributed under the License is distributed on an "AS IS" BASIS,
# WITHOUT WARRANTIES OR CONDITIONS OF ANY KIND, either express or implied.
# See the License for the specific language governing permissions and
# limitations under the License.

"""The privacy plane on the card: threefry's words and float draws
(``uniform``, ``normal``, ``gumbel``, ``categorical``), the fixed-point
codec, masking and the ring sum, the DP clip and noise and the int8
quantizer computed on a CUDA device equal the CPU path's bitwise (the
CPU path is held against ``jax.random`` and the JAX package by
tests/test_torch_threefry.py, tests/test_torch_privacy.py,
tests/test_torch_dp.py and tests/test_torch_quantize.py).
Every test here is marked ``cuda`` and skips without a card. The file
imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_privacy.py
"""

import pytest
import torch

from rayfed_tpu_torch.privacy import PrivacyConfig, PrivacyManager
from rayfed_tpu_torch.privacy import dp, quantize, secagg, threefry

pytestmark = pytest.mark.cuda

PARTIES = ["alice", "bob", "carol"]
SEEDS = {("alice", "bob"): 2**62 + 7, ("alice", "carol"): 5,
         ("bob", "carol"): 2**40 + 5}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("shape", [(), (0,), (7,), (3, 5), (2, 3, 129),
                                   (4097,), (1 << 20,)], ids=str)
def test_threefry_on_the_card_equals_the_cpu(cuda_device, shape):
    key = threefry.fold_in(threefry.prng_key(2**40 + 5), 17)
    got = threefry.random_bits(key, shape, cuda_device)
    assert got.device.type == "cuda" and got.dtype == torch.int64
    assert torch.equal(got.cpu(), threefry.random_bits(key, shape))


def test_a_range_from_its_counters_is_the_stream_slice(cuda_device,
                                                      monkeypatch):
    key = threefry.fold_in(threefry.prng_key(3), 9)
    n = (1 << 22) + 1000  # past one chunk
    whole = threefry.random_bits(key, (n,), cuda_device)
    monkeypatch.setattr(threefry, "CHUNK_WORDS", 1 << 12)
    for start, stop in ((0, 100), (n - 4097, n),
                        ((1 << 22) - 7, (1 << 22) + 9)):
        part = threefry.words(key, start, stop, cuda_device)
        assert torch.equal(part, whole[start:stop])
        assert torch.equal(part.cpu(), threefry.words(key, start, stop))
    # Counters past 2**32 (a stream longer than any leaf here): the card
    # hashes the high word as the CPU does.
    assert torch.equal(
        threefry.words(key, 2**32 - 3, 2**32 + 3, cuda_device).cpu(),
        threefry.words(key, 2**32 - 3, 2**32 + 3))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16, torch.float64],
                         ids=lambda d: str(d).rpartition(".")[2])
def test_encode_and_decode_on_the_card_equal_the_cpu(cuda_device, dtype):
    gen = torch.Generator().manual_seed(1)
    x = (torch.randn(257, 33, generator=gen) * 40).to(dtype)
    tree = {"w": x, "b": x[0].clone()}
    ring, dtypes, spec = secagg.encode_tree(tree, 16, 3)
    ring_c, dtypes_c, _ = secagg.encode_tree(
        {k: v.to(cuda_device) for k, v in tree.items()}, 16, 3)
    assert dtypes == dtypes_c
    for a, b in zip(ring, ring_c):
        assert b.device.type == "cuda" and torch.equal(a, b.cpu())
    sums = [(w * 3 + 12345) & 0xFFFFFFFF for w in ring]
    out = secagg.decode_sum(sums, dtypes, spec, 16)
    out_c = secagg.decode_sum([s.to(cuda_device) for s in sums], dtypes,
                              spec, 16)
    for k in out:
        assert out_c[k].device.type == "cuda"
        assert torch.equal(out[k], out_c[k].cpu())
        assert out[k].dtype == dtype


def _managers():
    out = {}
    for p in PARTIES:
        mgr = PrivacyManager("job", p, PrivacyConfig(secure_aggregation=True))
        for (a, b), seed in SEEDS.items():
            if p in (a, b):
                mgr.store_seed(b if p == a else a, seed)
        out[p] = mgr
    return out


def test_a_secure_round_on_the_card_equals_the_cpu(cuda_device):
    """Masks, the uint32 envelope leaves, the ring sum, a dropout's
    orphan correction and the decoded mean: the card's are the CPU's."""
    gen = torch.Generator().manual_seed(2)
    trees = {p: {"w": torch.randn(300, 70, generator=gen),
                 "b": torch.randn(70, generator=gen)} for p in PARTIES}
    results = {}
    for dev in (torch.device("cpu"), cuda_device):
        managers = _managers()
        envs = {p: managers[p].mask_contribution(
            {k: v.to(dev) for k, v in trees[p].items()}, party=p,
            parties=PARTIES, domain="fedagg", round_index=3)
            for p in PARTIES}
        for env in envs.values():
            for leaf in secagg._leaves(env["q"])[0]:
                assert leaf.dtype == torch.uint32 and leaf.device == dev
        full = managers["alice"].secure_reduce("mean", PARTIES, "fedagg", 3,
                                               None, envs)
        del envs["carol"]
        managers["alice"].store_recovery("carol", "bob",
                                         SEEDS[("bob", "carol")])
        dropped = managers["alice"].secure_reduce("mean", PARTIES, "fedagg",
                                                  3, None, envs)
        results[dev.type] = (envs, full, dropped)
    cpu, card = results["cpu"], results["cuda"]
    for p in ("alice", "bob"):
        for a, b in zip(secagg._leaves(cpu[0][p]["q"])[0],
                        secagg._leaves(card[0][p]["q"])[0]):
            assert torch.equal(a.to(torch.int64), b.cpu().to(torch.int64))
    for i in (1, 2):
        for k in ("w", "b"):
            assert card[i][k].device.type == "cuda"
            assert torch.equal(cpu[i][k], card[i][k].cpu())


# ---------------------------------------------------------------------------
# Float draws, DP and the quantizer
# ---------------------------------------------------------------------------


def _bits_equal(a, b):
    assert a.device.type == "cuda"
    a = a.cpu()
    assert a.dtype == b.dtype and a.shape == b.shape
    if a.is_floating_point():
        w = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
        return torch.equal(a.view(w), b.view(w))
    return torch.equal(a, b)


@pytest.mark.parametrize("shape", [(7,), (64, 1000), ((1 << 22) + 5,)],
                         ids=str)
def test_float_draws_on_the_card_equal_the_cpu(cuda_device, shape):
    key = threefry.fold_in(threefry.prng_key(2**40 + 5), 23)
    for lo, hi in ((0.0, 1.0), (-3.3, 7.1)):
        assert _bits_equal(threefry.uniform(key, shape, lo, hi, cuda_device),
                           threefry.uniform(key, shape, lo, hi))
    assert _bits_equal(threefry.gumbel(key, shape, cuda_device),
                       threefry.gumbel(key, shape))
    assert _bits_equal(threefry.normal(key, shape, cuda_device),
                       threefry.normal(key, shape))


def test_xla_math_on_the_card_equals_the_cpu(cuda_device):
    gen = torch.Generator().manual_seed(4)
    x = torch.cat([torch.rand(1 << 16, generator=gen) * 2 - 1,
                   1 - torch.rand(1 << 16, generator=gen) * 1e-6,
                   torch.tensor([0.0, 1e-40, -1e-40, 1.0, -1.0])])
    for fn in (threefry.xla_erf_inv, threefry.xla_log1p):
        assert _bits_equal(fn(x.to(cuda_device)), fn(x))
    y = torch.exp(torch.rand(1 << 16, generator=gen) * 170 - 85)
    assert _bits_equal(threefry.xla_log(y.to(cuda_device)),
                       threefry.xla_log(y))


def test_categorical_on_the_card_equals_the_cpu(cuda_device):
    gen = torch.Generator().manual_seed(5)
    logits = torch.randn(8, 32000, generator=gen) * 3
    logits[:, 7] = float("-inf")
    for seed in range(3):
        key = threefry.prng_key(seed)
        got = threefry.categorical(key, logits.to(cuda_device))
        assert torch.equal(got.cpu(), threefry.categorical(key, logits))


def _tree(gen, dtype=torch.float32):
    return {"w": (torch.randn(300, 1001, generator=gen) * 2).to(dtype),
            "b": torch.randn(70, generator=gen).to(dtype),
            "h": (torch.randn(130, generator=gen) * 5).half()}


def test_clip_and_noise_on_the_card_equal_the_cpu(cuda_device):
    gen = torch.Generator().manual_seed(6)
    tree = _tree(gen)
    card = {k: v.to(cuda_device) for k, v in tree.items()}
    assert dp.tree_l2_norm(card) == dp.tree_l2_norm(tree)
    for clip in (0.5, 1e9):
        got = dp.clip_tree(card, clip)
        want = dp.clip_tree(tree, clip)
        for k in tree:
            assert _bits_equal(got[k], want[k])
    got = dp.gaussian_noise_tree(card, 0.37, 99, 4)
    want = dp.gaussian_noise_tree(tree, 0.37, 99, 4)
    for k in tree:
        assert _bits_equal(got[k], want[k])


def test_quantizer_on_the_card_equals_the_cpu(cuda_device):
    from rayfed_tpu_torch._private import serialization as ser

    gen = torch.Generator().manual_seed(7)
    tree = _tree(gen)
    card = {k: v.to(cuda_device) for k, v in tree.items()}
    env, env_c = quantize.quantize_tree(tree), quantize.quantize_tree(card)
    assert env["scales"] == env_c["scales"]
    for k in env["q"]:
        assert torch.equal(env["q"][k], env_c["q"][k].cpu())
    back = quantize.dequantize_tree(env_c)
    for k, v in quantize.dequantize_tree(env).items():
        assert _bits_equal(back[k], v)
    # The int8 wire tier quantizes a card leaf on the card: the frame is
    # the CPU leaf's, byte for byte.
    meta, bufs = ser.try_encode_tree(tree, wire_dtype="int8")
    meta_c, bufs_c = ser.try_encode_tree(card, wire_dtype="int8")
    assert meta == meta_c
    assert [bytes(memoryview(b).cast("B")) for b in bufs] == \
        [bytes(memoryview(b).cast("B")) for b in bufs_c]
    ef, ef_c = quantize.ErrorFeedbackQuantizer(), \
        quantize.ErrorFeedbackQuantizer()
    for _ in range(3):
        a, b = ef.quantize("p", tree), ef_c.quantize("p", card)
        assert a["scales"] == b["scales"]
        res, res_c = ef.residual("p"), ef_c.residual("p")
        for k in res:
            assert _bits_equal(res_c[k], res[k])
