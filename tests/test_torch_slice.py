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

"""The port's slice end to end: two parties, local steps, the FedAvg fold,
the next round from the aggregate — against the same loop in the JAX
package — plus ``chip_smoke.py``'s round-loop phase at tiny size on the
CPU, the port's import isolation and its refusal to run without a card.

Tolerances (f32 compute): every party's loss at every step, and the
final aggregate's loss, to 1e-5. The aggregate's params per leaf: the
difference's norm within 1e-4 of the leaf's norm, and no entry off by
more than one step's learning rate. AdamW divides each gradient by its
own running magnitude, so an entry whose gradient is of the order of eps
turns a last-bit gradient difference into a visible share of its step."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import chip_smoke
from rayfed_tpu import data as jdata
from rayfed_tpu.models import transformer as jtfm
from rayfed_tpu.ops import aggregate as jagg
from rayfed_tpu.parallel.train import make_fed_train_step as j_make_step
from rayfed_tpu_torch import data as tdata
from rayfed_tpu_torch.models import transformer as tfm

# The suite runs in several worker processes on one host: a small torch
# thread pool keeps these tests from starving timing-sensitive ones.
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_TOL = 1e-5
LR = 1e-2
PARAM_NORM_TOL = 1e-4
PARTIES = chip_smoke.PARTIES
BATCH, SEQ, ROUNDS, LOCAL_STEPS = 2, 32, 2, 2


def _jax_rounds(jcfg, init):
    """The same loop as ``chip_smoke.fedavg_rounds`` in the JAX package."""
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    init_fn, step_fn = j_make_step(jcfg, mesh, party_axis=None,
                                   data_axis="data", attn="flash", lr=LR,
                                   donate=False)
    data = {n: jdata.synthetic_lm_dataset(
        jcfg.vocab, BATCH * LOCAL_STEPS * (SEQ + 1), SEQ, seed=s)
        for n, s in PARTIES}
    params0, opt0 = init_fn(jax.random.PRNGKey(0), None)
    params0 = jax.tree_util.tree_map(jnp.asarray, init)
    state = {n: (params0, opt0) for n in data}
    losses = {n: [] for n in data}
    for r in range(ROUNDS):
        for n in data:
            params, opt = state[n]
            for blk in data[n].batches(BATCH, epoch=r):
                params, opt, loss = step_fn(params, opt, jnp.asarray(blk[:, :-1]),
                                            jnp.asarray(blk[:, 1:]))
                losses[n].append(float(loss))
            state[n] = (params, opt)
        agg = jagg.tree_mean(*[state[n][0] for n in data])
        state = {n: (agg, state[n][1]) for n in data}
    return losses, jax.tree_util.tree_map(np.asarray, agg)


def test_two_party_rounds_match_reference():
    jcfg = jtfm.tiny_config(compute_dtype=jnp.float32)
    tcfg = tfm.tiny_config(compute_dtype=torch.float32)
    init = jax.tree_util.tree_map(
        np.asarray, jtfm.init_params(jax.random.PRNGKey(0), jcfg))
    jlosses, jagg_params = _jax_rounds(jcfg, init)
    run = chip_smoke.fedavg_rounds(tcfg, "cpu", batch=BATCH, seq=SEQ,
                                   rounds=ROUNDS, local_steps=LOCAL_STEPS,
                                   lr=LR, init=init)
    assert run["starts_identical"] == [True] * ROUNDS
    for name, _ in PARTIES:
        assert len(run["losses"][name]) == ROUNDS * LOCAL_STEPS
        np.testing.assert_allclose(run["losses"][name], jlosses[name],
                                   rtol=LOSS_TOL, atol=LOSS_TOL)
    blk = run["eval_block"].numpy()
    want_eval = jtfm.lm_loss_pair(jax.tree_util.tree_map(jnp.asarray, jagg_params),
                                  jnp.asarray(blk[:, :-1]),
                                  jnp.asarray(blk[:, 1:]), jcfg)
    np.testing.assert_allclose(run["eval"][-1], float(want_eval),
                               rtol=LOSS_TOL, atol=LOSS_TOL)
    got = dict(jax.tree_util.tree_leaves_with_path(
        tfm.params_to_numpy(run["aggregate"])))
    for path, want in jax.tree_util.tree_leaves_with_path(jagg_params):
        diff = got[path] - want
        key = jax.tree_util.keystr(path)
        assert np.linalg.norm(diff) <= PARAM_NORM_TOL * np.linalg.norm(want), key
        assert np.abs(diff).max() <= LR, key


def test_party_data_matches_reference_windows():
    for _, seed in PARTIES:
        want = jdata.synthetic_lm_dataset(256, 1000, SEQ, seed=seed)
        got = tdata.synthetic_lm_dataset(256, 1000, SEQ, seed=seed)
        assert len(got) == len(want)
        for epoch in (0, 1):
            for a, b in zip(got.batches(BATCH, epoch=epoch),
                            want.batches(BATCH, epoch=epoch)):
                assert a.dtype == np.int32
                np.testing.assert_array_equal(a, b)


def test_chip_smoke_slice_phase_on_cpu_at_tiny_size():
    summary = chip_smoke.phase_slice("cpu", tfm.tiny_config(), batch=BATCH,
                                     seq=SEQ, rounds=2, local_steps=2,
                                     lr=LR, label="tiny")
    assert summary["eval"][-1] < summary["eval"][0]
    assert all(len(v) == 4 for v in summary["losses"].values())
    # The CPU run takes the plain versions: no kernel launches.
    none = {k["name"]: 0 for k in chip_smoke.KERNELS}
    assert summary["launches"] == none
    assert summary["eval_launches"] == none
    assert summary["max_memory_allocated"] is None


def test_chip_smoke_fed_phase_on_cpu_at_tiny_size():
    # Phase 5's program, two spawned party processes over the port's
    # engine, end to end at tiny size; phase_fed itself fails on any of
    # its checks (a)-(f) but (e), which needs the card.
    results = chip_smoke.phase_fed("cpu", tfm.tiny_config(), batch=BATCH,
                                   seq=SEQ, lr=LR, timeout_s=60)
    res = results[PARTIES[0][0]]
    assert len(res["rounds"]) == chip_smoke.FED_ROUNDS
    assert res["evals"][-1] < res["evals"][0]
    for rnd in res["rounds"]:
        assert rnd["starts_identical"]
        for push in ("params_push", "aggregate_push"):
            got = rnd[push]
            assert got["digest"] == got["owner_digest"]
            assert got["push_ms"] > 0 and got["stage_ms"] is not None
    # Both parties ran the port's native lane (built here by g++).
    assert {rep["io_path"] for rep in res["reports"].values()} == {"native"}


def test_chip_smoke_fed_phase_on_the_python_io_path_at_tiny_size():
    # Phase 5's comparison run: its parties drop the native module and
    # run sockio's Python IO path; check (g) holds them to it.
    results = chip_smoke.phase_fed("cpu", tfm.tiny_config(), batch=BATCH,
                                   seq=SEQ, lr=LR, timeout_s=60,
                                   io_path="python")
    res = results[PARTIES[0][0]]
    assert {rep["io_path"] for rep in res["reports"].values()} == {"python"}
    assert all(rnd[push]["digest"] == rnd[push]["owner_digest"]
               for rnd in res["rounds"]
               for push in ("params_push", "aggregate_push"))
    chip_smoke.compare_io_paths({"native": results, "python": results})


def test_chip_smoke_async_phase_on_cpu_at_tiny_size():
    # Phase 8's program, three spawned party processes (carol joins and
    # leaves mid-job), end to end at tiny size: phase_async fails on any
    # of its checks (a)-(g) ((h) needs the card).
    results = chip_smoke.phase_async(
        "cpu", tfm.tiny_config(), batch=BATCH, seq=SEQ, label="cpu:",
        straggler=dict(chip_smoke.ASYNC_STRAGGLER, stall_s=3.0),
        timeout_s=150)
    res = results["alice"]
    assert res["n_offers"] == chip_smoke.ASYNC_ROUNDS + 1
    assert [v["version"] for v in res["versions"]] == [1, 2, 3]
    # carol's offer (round 3) lands before bob's stalled round-2 offer.
    v2 = res["versions"][1]["contributions"]
    assert [(c["party"], c["round_tag"], c["staleness"]) for c in v2] == [
        ("carol", 3, 0), ("bob", 2, 1)]
    assert v2[1]["weight"] == 2 ** -0.5


def test_chip_smoke_f32_phase_on_cpu_at_tiny_size():
    # Phase 4b at tiny size: the f32 steps (the dense attention on the
    # CPU) and the batch-1 check of the flash path's loss and gradients
    # against the dense attention's.
    summary = chip_smoke.phase_f32("cpu", tfm.tiny_config(), batch=BATCH,
                                   seq=SEQ, steps=2, lr=LR, label="tiny")
    assert len(summary["losses"]) == 3
    assert summary["loss_rel"] <= chip_smoke.F32_LOSS_RTOL
    assert summary["grad_rel"] <= chip_smoke.F32_GRAD_RTOL
    assert all(n == 0 for n in summary["launches"].values())
    # The profiled extra step found no device kernel on the CPU.
    assert summary["breakdown"] is None


def test_kernel_work_counts_the_causal_pairs():
    for b, sq, sk, h, off in [(1, 8, 8, 1, 0), (2, 5, 9, 3, 4), (1, 6, 4, 2, 0)]:
        q_pos = np.arange(sq)[:, None] + off
        pairs = int((q_pos >= np.arange(sk)[None, :]).sum()) * b * h
        assert chip_smoke.causal_pairs(b, sq, sk, h, off) == pairs
    flops, nbytes = chip_smoke.kernel_work(1, 64, 64, 2, 16, 0)["flash_fwd"]
    assert flops == 4 * 16 * (64 * 65 // 2) * 2
    assert nbytes == 4 * 64 * 2 * 16 * 2 + 64 * 2 * 4
    # f32: four bytes an element of q/k/v/o; lse stays f32.
    flops32, nbytes32 = chip_smoke.kernel_work(1, 64, 64, 2, 16, 0,
                                               elem=4)["flash_fwd"]
    assert flops32 == flops
    assert nbytes32 == 4 * 64 * 2 * 16 * 4 + 64 * 2 * 4


def test_bound_takes_the_faster_exact_route_for_f32():
    # The main path's K1: 402.9M kept pairs, 206.3 GFLOP.
    flops, nbytes = chip_smoke.kernel_work(12, 2048, 2048, 16, 128, 0,
                                           elem=4)["flash_fwd"]
    ms, by = chip_smoke.bound(flops, nbytes, "float32")
    assert by == "operations"
    assert ms == pytest.approx(1e3 * 3 * flops / 495e12)  # split TF32
    assert ms == pytest.approx(1.250, abs=1e-3)
    ms16, _ = chip_smoke.bound(flops, nbytes // 2, "bfloat16")
    assert ms16 == pytest.approx(1e3 * flops / 989e12)


def test_tile_rel_err_passes_rounding_and_catches_a_skipped_tile():
    # Causal attention in f32; its bf16 rounding must pass chip_smoke's
    # limit, and the same attention with one mid-sequence key tile dropped
    # for the rows after it (a kernel that skips a tile) must not.
    g = torch.Generator().manual_seed(0)
    b, s, h, d, tile = 1, 1024, 2, 32, chip_smoke.TILE
    q, k, v = (torch.randn((b, h, s, d), generator=g) for _ in range(3))
    mask = torch.ones(s, s).tril().bool()
    faulty = mask.clone()
    faulty[8 * tile + tile:, 8 * tile:9 * tile] = False

    def attn(m):
        sc = (q @ k.transpose(-1, -2)) * d ** -0.5
        return torch.softmax(sc.masked_fill(~m, -1e30), -1) @ v

    want = attn(mask).transpose(1, 2)
    lim = chip_smoke.BF16_TILE_REL_TOL
    assert chip_smoke.tile_rel_err(want.bfloat16(), want) <= lim / 2
    assert chip_smoke.tile_rel_err(attn(faulty).transpose(1, 2), want) > 5 * lim


def test_sdpa_backend_reads_the_kernel_names():
    # Names printed by chip runs: cuDNN's contain "flash" too.
    assert chip_smoke.sdpa_backend([
        "cudnn_generated_fort_native_sdpa_sm90_flash_fprop_wgmma_f16_knob_7",
        "void cudnn::fusion::compute_dot_do_o_specialized<true, 128>"]) \
        == "cudnn"
    assert chip_smoke.sdpa_backend([
        "fmha_cutlassF_f32_aligned_64x128_rf_sm80(PyTorchMemEffAttention)"]) \
        == "efficient"
    assert chip_smoke.sdpa_backend(
        ["void pytorch_flash::flash_fwd_kernel<Flash_fwd_kernel_traits>"]) \
        == "flash"
    assert chip_smoke.sdpa_backend(["void at::native::softmax_warp"]) == "math"


def test_parse_sass_counts_reads_each_kernels_instructions():
    # The layout of ``cuobjdump -sass``: a "Function :" header per kernel
    # instantiation, then one instruction a line.
    sass = "\n".join([
        "\t\tFunction : _ZN12_GLOBAL__N_123flash_bwd_dq_f32_kernelILi128ELi8E"
        "Li32EEEvNS_6ParamsE",
        "        /*0100*/  HMMA.1688.F32.TF32 R4, R8, R12, R4 ;",
        "        /*0110*/  HMMA.1688.F32.TF32 R4, R16, R12, R4 ;",
        "        /*0120*/  FFMA R2, R3, R5, R2 ;",
        "\t\tFunction : _ZN12_GLOBAL__N_116flash_fwd_kernelILi64ELi2ELi128E"
        "EEvNS_6ParamsE",
        "        /*0200*/  HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], R24 ;",
        "\t\tFunction : _Z9unrelatedv",
        "        /*0300*/  HMMA.1688.F32.TF32 R4, R8, R12, R4 ;",
    ])
    assert chip_smoke.parse_sass_counts(sass) == {
        "flash_bwd_dq_f32_kernel<128>": {"HMMA": 2, "HGMMA": 0, "FFMA": 1},
        "flash_fwd_kernel<64>": {"HMMA": 0, "HGMMA": 1, "FFMA": 0},
    }


def test_kernel_split_groups_and_unions_device_time():
    kernels = [
        {"name": "flash_fwd_kernel<128>", "ts": 0.0, "dur": 100.0},
        {"name": "sm90_xmma_gemm_bf16", "ts": 50.0, "dur": 100.0},  # overlaps
        {"name": "nvjet_tst_128x256", "ts": 300.0, "dur": 50.0},
        {"name": "vectorized_elementwise_kernel", "ts": 400.0, "dur": 10.0},
    ]
    out = chip_smoke.kernel_split(kernels, wall_us=1000.0)
    assert out["flash"] == pytest.approx(0.1)
    assert out["matmul"] == pytest.approx(0.15)
    assert out["other"] == pytest.approx(0.01)
    assert out["busy_ms"] == pytest.approx(0.21)  # 0-150, 300-350, 400-410
    assert out["idle_share"] == pytest.approx(0.79)
    assert out["n_kernels"] == 4


def test_ptxas_report_names_each_kernel():
    log = (
        "ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__eb3e0d29"
        "_18_flash_attention_cu_1747f3c420flash_bwd_dkv_kernelILi128EEEvNS_"
        "6ParamsE' for 'sm_90a'\n"
        "ptxas info    : Function properties for _ZN51_GLOBAL__N__x\n"
        "    64 bytes stack frame, 60 bytes spill stores, 76 bytes spill loads\n"
        "ptxas info    : Used 255 registers, used 1 barriers\n"
    )
    assert chip_smoke.ptxas_report(log) == [
        "flash_bwd_dkv_kernel<128>: 64 bytes stack frame, 60 bytes spill "
        "stores, 76 bytes spill loads",
        "flash_bwd_dkv_kernel<128>: Used 255 registers, used 1 barriers",
    ]


def test_ptxas_spills_sums_stores_and_loads_per_kernel():
    log = (
        "ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__eb3e0d29"
        "_18_flash_attention_cu_1747f3c420flash_bwd_dkv_kernelILi128EEEvNS_"
        "6ParamsE' for 'sm_90a'\n"
        "    64 bytes stack frame, 60 bytes spill stores, 76 bytes spill loads\n"
        "ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__eb3e0d29"
        "_18_flash_attention_cu_1747f3c416flash_fwd_kernelILi64ELi1EEEvNS_"
        "6ParamsE' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
    )
    assert chip_smoke.ptxas_spills(log) == {
        "flash_bwd_dkv_kernel<128>": 136, "flash_fwd_kernel<64>": 0}


def test_port_imports_neither_jax_nor_the_jax_package():
    # Every module imports, and a party's fed.init / fed.shutdown runs,
    # without jax, the JAX package, msgpack, cloudpickle or ml_dtypes.
    code = (
        "import importlib, pkgutil, socket, sys\n"
        "import rayfed_tpu_torch as fed, chip_smoke\n"
        "for m in pkgutil.walk_packages(fed.__path__, 'rayfed_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "s = socket.socket(); s.bind(('127.0.0.1', 0))\n"
        "port = s.getsockname()[1]; s.close()\n"
        "fed.init(addresses={'alice': f'127.0.0.1:{port}'}, party='alice')\n"
        "@fed.remote\n"
        "def f(x):\n"
        "    return x + 1\n"
        "assert fed.get(f.party('alice').remote(1)) == 2\n"
        "fed.shutdown()\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'rayfed_tpu',\n"
        "             'msgpack', 'cloudpickle', 'ml_dtypes')\n"
        "             or m.startswith(('jax.', 'jaxlib', 'rayfed_tpu.',\n"
        "                              'msgpack.', 'cloudpickle.')))\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('rayfed_tpu_torch')]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) >= 40  # every module


def test_chip_smoke_programs_phase_at_tiny_size_on_cpu():
    # Phase 6 on the CPU: the example programs over the TCP lane; the
    # phase itself fails on any of its checks (a)-(d).
    out = chip_smoke.phase_programs("cpu", tfm.tiny_config(), batch=BATCH,
                                    seq=SEQ, timeout_s=240)
    res = out["results"]["alice"]
    assert len(res["checks"]) == chip_smoke.PROGRAM_ROUNDS
    assert all(c["mismatched"] == 0 for c in res["checks"])
    assert all(c["mismatched3"] == 0 and c["elements3"] > 0
               for c in res["checks"])
    # One params push and one aggregate push a round.
    assert [(p["src"], p["dst"]) for p in out["pushes"]] == \
        [("bob", "alice"), ("alice", "bob")] * chip_smoke.PROGRAM_ROUNDS


TINY_SERVE = dict(max_slots=4, max_len=96, max_new_tokens=8, max_pending=64)


def test_chip_smoke_serving_phase_on_cpu_at_tiny_size():
    # Phase 7's single-process run at tiny size: the phase itself fails on
    # any of its checks (a)-(e); prompts span the prefill chunk (32).
    cfg = tfm.tiny_config(vocab=512)
    out = chip_smoke.phase_serving("cpu", cfg, scfg_kw=TINY_SERVE,
                                   n_requests=12, clients=4,
                                   prompt_len=(16, 80), label="tiny")
    assert sum(out["versions"].values()) == 12 and out["versions"][2] > 0
    assert out["steps"] > 0 and out["chunks"] > 0 and out["prefills"] > 0
    assert out["tokens"] == 12 * TINY_SERVE["max_new_tokens"]
    assert all(r <= chip_smoke.SERVE_LOGIT_TOL
               for r in out["logit_ratios"].values())
    assert len(out["logit_ratios"]) == 4
    # A CPU run: no device numbers, no kernel launches.
    assert out["breakdown"] is None and out["max_memory_allocated"] is None
    assert all(n == 0 for n in out["flash_launches"].values())


def test_chip_smoke_serve_fed_phase_on_cpu_at_tiny_size():
    # Phase 7's two-process run at tiny size: fed.serve in two spawned
    # parties, fed_aggregate(publish_to=) mid-load; the phase fails unless
    # both versions served and every response matches alice's reference.
    out = chip_smoke.phase_serve_fed("cpu", tfm.tiny_config(vocab=512),
                                     scfg_kw=TINY_SERVE, n_requests=6,
                                     prompt_len=(16, 60), timeout_s=120)
    res = out["results"]["alice"]
    assert res["mismatched"] == [] and set(res["versions"]) == {1, 2}


def test_serve_prompts_are_seeded_and_in_range():
    a = chip_smoke.serve_prompts(20, 16, 512, 32768)
    assert a == chip_smoke.serve_prompts(20, 16, 512, 32768)
    assert all(16 <= len(p) <= 512 for p in a)
    assert all(1 <= t < 32768 for p in a for t in p)
    assert a != chip_smoke.serve_prompts(20, 16, 512, 32768, seed=8)


def test_port_reset_hooks_run_clean_and_cover_its_singletons():
    from rayfed_tpu_torch.tenancy import reset

    assert reset.run_all_reset_hooks() == []
    assert reset.verify_inventory_coverage() == []


def test_chip_smoke_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present; the no-card refusal cannot show")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and "no CUDA device" in out.stderr
    # Alone in a directory, without the package, it fails too.
    lone = tmp_path / "chip_smoke.py"
    lone.write_text(open(os.path.join(REPO, "chip_smoke.py")).read())
    out = subprocess.run([sys.executable, str(lone)], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout


def test_chip_smoke_family_phase_on_cpu_at_tiny_size():
    # Phase 9 at tiny size: the MoE steps under each remat mode, their
    # bitwise agreement, MoE cached decode and the LoRA program in two
    # spawned parties; phase_family fails on any of its checks but the
    # launch counts, which need the card.
    out = chip_smoke.phase_family("cpu", tfm.tiny_config(vocab=512),
                                  batch=BATCH, seq=SEQ, label="tiny",
                                  lora_timeout_s=180)
    assert set(out["modes"]) == set(chip_smoke.REMAT_MODES)
    assert len(out["modes"]["attn"]["losses"]) == chip_smoke.FAMILY_STEPS
    assert all(n == 0 for n in out["launches"].values())
    assert out["agree"]["attn"]["mismatched"] == 0
    assert out["decode"]["same_as_loop"]
    assert len(out["decode"]["greedy"]) == chip_smoke.FAMILY_DECODE_NEW
    res = out["lora"]["results"]["alice"]
    assert len(res["rounds"]) == chip_smoke.FAMILY_LORA_ROUNDS
    assert out["lora"]["base_bytes"] > 5 * out["lora"]["adapter_bytes"]
