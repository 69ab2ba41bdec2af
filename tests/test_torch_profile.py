"""The port's profilers and kernel census on the CPU, at small sizes (64
envs, unroll 4, 4 minibatches, eval 8 envs x 5 steps), through the port's
own functions:

- each tool's `main([...], device="cpu")` returns its record with every
  section, finite (on the CPU nothing is traced: the device sections are
  None, and `forward.step` is the plain engine, so no kernel launches);
- `profile_step`'s physics section ends where `forward.step` chained
  directly ends, bit for bit, and the layers of both its control steps
  (the env step graphed on the card, and eager) are the program's spans;
- the epoch `profile_train_step` times, from a `ppo.training_step`'s
  state and draws, ends at that step's parameters, bit for bit (the same
  operations in the same order);
- each `profile_epoch` variant declared to compute the production epoch is
  within a relative 1e-6 of its parameters after one epoch (the same
  products on differently laid-out minibatches sum in another order: f32
  rounding, 3e-7 seen); the CUDA-graph variant raises on the CPU;
- each `profile_shuffle` strategy gives `ppo.minibatch`'s payloads for the
  same permutation, and the JAX production shuffle
  (`jnp.take(jnp.swapaxes(x, 0, 1), perm, 0)`, tools/profile_epoch.py:
  147-159) the same arrays, bit for bit (pure data movement);
- `count_kernel_ops`' parser on a hand-written listing with PERF.md's
  three FFMA forms and every opcode class, exactly;
- `megakernel_work`, moved from chip_smoke.py, gives the tuples it gave
  there (exact: the same float arithmetic);
- `gen_no_head_xml` writes the bytes of the JAX tool and of the committed
  XML;
- `benchutil.coverage` on a hand-made trace counts the launches whose
  device event is missing and the least launch-to-start time, exactly;
  `benchutil.span_stats` places its launches and idle gaps by the innermost
  program span, exactly;
  `profile_window` builds and runs its control step (nothing traced).
"""

import importlib.util
import pathlib
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_duck_playground_torch.envs.joystick import Joystick
from open_duck_playground_torch.envs.randomize import DRDraws, domain_randomize
from open_duck_playground_torch.envs.wrappers import TrainingEnv
from open_duck_playground_torch.models import loader
from open_duck_playground_torch.physics import forward as F
from open_duck_playground_torch.tools import (benchutil, count_kernel_ops as CK, gen_no_head_xml, profile_epoch,
                                              profile_shuffle, profile_step, profile_train_step, profile_window)
from open_duck_playground_torch.train import ppo
from open_duck_playground_torch.train import running_stats as RS
from open_duck_playground_torch.train.config import PPOConfig

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
SMALL = ["--config_override", "batch_size=16", "--config_override", "num_minibatches=4",
         "--config_override", "unroll_length=4"]
SMALL_CFG = PPOConfig(num_envs=64, batch_size=16, num_minibatches=4, unroll_length=4)


def finite_numbers(tree) -> bool:
    if isinstance(tree, dict):
        return all(finite_numbers(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return all(finite_numbers(v) for v in tree)
    if isinstance(tree, bool) or tree is None or isinstance(tree, str):
        return True
    return bool(np.isfinite(tree))


def test_profile_step_record_and_physics_bit_for_bit():
    record, outputs = profile_step.profile(["--envs", "8", "--steps", "2", "--reps", "1"], device="cpu")
    pieces = ("physics", "env_step", "eval_step", "eval_step_eager", "gait_oracle")
    assert set(pieces) | {"layers", "layers_eager", "finite"} <= set(record) and record["finite"]
    for p in pieces:
        assert record[p]["env_steps_per_s"] > 0 and record[p]["us_per_batch_step"] > 0
        assert record[p]["megakernel_launches_per_step"] == 0  # the plain engine on the CPU
        assert record[p]["trace"] is None and record[p]["host_syncs"] is None
    # on the CPU both control steps run the env step eagerly: no graph span
    for layers in ("layers", "layers_eager"):
        assert set(record[layers]) == {"policy_us", "draws_us", "wrapper_us", "task_us", "physics_us"}
        assert all(v > 0 for v in record[layers].values())
    assert finite_numbers(record)
    env = Joystick("flat_terrain_backlash", device=CPU)
    gen = torch.Generator().manual_seed(0)
    d = env.reset(env.reset_draws(gen, 8)).data
    ctrl = env.model.key_ctrl.expand(8, -1).contiguous()
    for _ in range(2):
        d = F.step(env.model, d, ctrl, env.n_substeps)
    for field in ("qpos", "qvel", "qacc_warmstart", "sensordata"):
        assert torch.equal(getattr(outputs["physics"], field), getattr(d, field)), field


def test_profile_train_step_record_has_every_section():
    record = profile_train_step.main(["--num-envs", "64", "--reps", "1", "--eval-envs", "8", "--eval-steps", "5",
                                      "--eval-reps", "1", *SMALL], device="cpu")
    assert set(record["ms"]) == {"rollout", "rollout_env_only", "normalizer_update", "sgd_epoch", "shuffle_only",
                                 "minibatches_preshuffled", "eval", "training_step"}
    assert all(v > 0 for v in record["ms"].values()) and finite_numbers(record) and record["finite"]
    assert record["sum_rollout_and_epochs_ms"] == pytest.approx(
        record["ms"]["rollout"] + 4 * record["ms"]["sgd_epoch"])
    assert record["traced"] == {k: {"trace": None, "host_syncs": None} for k in ("control_step", "sgd_step")}
    assert record["rollout_megakernel_launches"] == 0 and record["device"] == "cpu"


def test_profile_train_step_epochs_end_at_the_training_steps_parameters():
    """The epoch that `profile_train_step` times (`profile_epoch.
    production`), run after the same rollout and normalizer merge once per
    epoch of a training step's `SGDDraws`, ends at that step's parameters."""
    cfg = SMALL_CFG
    env = Joystick("flat_terrain_backlash", device=CPU)
    gen = torch.Generator().manual_seed(3)
    train_env = TrainingEnv(env, cfg.episode_length, dr_draws=DRDraws.sample(gen, cfg.num_envs, env.model.spec),
                            randomization_fn=domain_randomize)
    state = train_env.reset(env.reset_draws(gen, cfg.num_envs))
    ts = ppo.init_training_state(state.obs, env.action_size, cfg, gen, device=CPU)
    copy = profile_epoch.clone_state(ts)
    unroll = ppo.unroll_draws(train_env, cfg.num_envs, cfg.unroll_length, gen)
    sgd = ppo.sgd_draws(cfg, env.action_size, gen)
    want, want_state, _ = ppo.training_step(ts, train_env, env, state, cfg, None, unroll, sgd)
    got_state, data, final_obs, moments = ppo.generate_unroll(train_env, copy.net, copy.normalizer, state, unroll)
    copy.normalizer = RS.merge_moments(copy.normalizer, float(cfg.num_envs * cfg.unroll_length), *moments)
    for perm, noise in zip(sgd.perms, sgd.entropy_noise):
        profile_epoch.production(copy, cfg, data, final_obs)(perm, noise)
    for a, b in zip(copy.net.parameters(), want.net.parameters()):
        assert torch.equal(a, b)
    for k in want.normalizer.mean:
        assert torch.equal(copy.normalizer.mean[k], want.normalizer.mean[k])
        assert torch.equal(copy.normalizer.std[k], want.normalizer.std[k])
    assert torch.equal(got_state.obs["state"], want_state.obs["state"])


@pytest.fixture(scope="module")
def epoch_inputs():
    cfg = SMALL_CFG
    gen = torch.Generator().manual_seed(0)
    data, final_obs = profile_epoch.payload(cfg, gen)
    ts = ppo.init_training_state(final_obs, profile_epoch.ACTION_SIZE, cfg, gen, device=CPU)
    return cfg, ts, data, final_obs, ppo.sgd_draws(cfg, profile_epoch.ACTION_SIZE, gen)


@pytest.mark.parametrize("variant", [v for v, same in profile_epoch.SAME_FUNCTION.items()
                                     if same and not v.startswith("graph")])
def test_profile_epoch_variant_computes_the_production_epoch(epoch_inputs, variant):
    cfg, ts, data, final_obs, draws = epoch_inputs
    out = profile_epoch.profile(ts, cfg, data, final_obs, draws, [variant], warmup=0, reps=1, dev=CPU)
    assert out[variant]["same_function"] and out[variant]["finite"]
    assert out[variant]["rel_diff"] <= 1e-6, out[variant]


def test_profile_epoch_record_and_graph_raises_on_the_cpu(epoch_inputs):
    record = profile_epoch.main(["--num-envs", "64", "--warmup", "0", "--reps", "1", *SMALL], device="cpu")
    assert set(record["variants"]) == {v for v in profile_epoch.VARIANTS if not v.startswith("graph")}
    assert finite_numbers(record) and all(v["ms_per_epoch"] > 0 and v["finite"] for v in record["variants"].values())
    assert record["variants"]["production"]["rel_diff"] == 0
    # contiguous minibatches are another function: the parameters part
    assert record["variants"]["no_shuffle"]["rel_diff"] > 1e-3
    cfg, ts, data, final_obs, _ = epoch_inputs
    with pytest.raises(RuntimeError, match="card"):
        profile_epoch.graph(4)(profile_epoch.clone_state(ts), cfg, data, final_obs)


@pytest.fixture(scope="module")
def shuffle_inputs():
    """A numpy-seeded payload (T 4, B 64) and permutation, in torch."""
    rng = np.random.default_rng(5)
    T, B = 4, 64
    np_data = {"obs": {k: rng.standard_normal((T, B, n)).astype(np.float32)
                       for k, n in profile_shuffle.OBS_SIZES.items()},
               "raw_action": rng.standard_normal((T, B, 14)).astype(np.float32),
               **{k: rng.standard_normal((T, B)).astype(np.float32)
                  for k in ("log_prob", "reward", "done", "truncation")}}
    np_final = {k: rng.standard_normal((B, n)).astype(np.float32) for k, n in profile_shuffle.OBS_SIZES.items()}
    perm = rng.permutation(B)
    to_torch = lambda tree: profile_epoch.tree_map(torch.from_numpy, tree)
    data, final_obs = to_torch(np_data), to_torch(np_final)
    datab = profile_epoch.tree_map(lambda x: x.transpose(0, 1).contiguous(), data)
    return np_data, np_final, perm, (data, datab, final_obs, torch.from_numpy(perm), 4)


@pytest.mark.parametrize("strategy", list(profile_shuffle.PERMUTING))
def test_profile_shuffle_strategy_gives_the_production_minibatches(shuffle_inputs, strategy):
    *_, inputs = shuffle_inputs
    data, _, final_obs, perm, nmb = inputs
    got = profile_shuffle.PERMUTING[strategy](*inputs)
    want = [ppo.minibatch(data, final_obs, envs) for envs in perm.reshape(nmb, -1)]
    assert profile_shuffle.same_minibatches(got, want)


def test_jax_production_shuffle_gives_the_same_arrays(shuffle_inputs):
    np_data, np_final, perm, inputs = shuffle_inputs
    nmb = inputs[-1]
    got = profile_shuffle.jax_production(*inputs)

    def jax_shuffle(x):  # tools/profile_epoch.py:147-159
        x = jnp.take(jnp.swapaxes(jnp.asarray(x), 0, 1), jnp.asarray(perm), axis=0)
        return np.asarray(x.reshape((nmb, -1) + x.shape[1:]))

    def jax_final(x):
        x = jnp.take(jnp.asarray(x), jnp.asarray(perm), axis=0)
        return np.asarray(x.reshape((nmb, -1) + x.shape[1:]))

    want = profile_epoch.tree_map(jax_shuffle, np_data)
    want_final = profile_epoch.tree_map(jax_final, np_final)
    for i, (mb, mb_final) in enumerate(got):
        for key, x in profile_shuffle.flat(mb).items():
            w = profile_shuffle.flat(want)[key][i]
            assert w.dtype == np.float32 and np.array_equal(x.numpy(), np.swapaxes(w, 0, 1)), key
        for key, x in mb_final.items():
            assert np.array_equal(x.numpy(), want_final[key][i]), key


def test_profile_shuffle_record():
    record = profile_shuffle.main(["--num-envs", "64", "--unroll-length", "4", "--num-minibatches", "4",
                                   "--reps", "1"], device="cpu")
    assert set(record["strategies"]) == {"permutation", "transpose", "gather_axis0", "gather_axis1",
                                         "jax_production", "deferred", "reduce_floor", "onehot_bf16"}
    assert finite_numbers(record) and all(v["ms"] > 0 for v in record["strategies"].values())
    assert {k for k, v in record["strategies"].items() if v.get("equal_to_production")} == set(profile_shuffle.PERMUTING)
    assert record["payload_bytes"] == 4 * (4 * 64 * (101 + 212 + 14 + 4) + 64 * (101 + 212))


LISTING = """
Fatbin elf code:
================
arch = sm_90a
\tcode for sm_90a
\t\tFunction : _Z9mk_kernel6MkArgs
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                       /* 0x00000a00ff017b82 */
                                                                              /* 0x000fe40000000800 */
        /*0010*/                   FFMA R12, R6, R12, R9 ;
        /*0020*/                   FFMA R10, R10, UR6, R9 ;
        /*0030*/                   FFMA R25, R7.reuse, R25, R8 ;
        /*0040*/                   FFMA R2, R3, 0.5, R4 ;
        /*0050*/                   FFMA R2, -R3, c[0x0][0x210], R4 ;
.L_x_1:
        /*0060*/                   FMUL R2, R3, R4 ;
        /*0070*/                   FADD R2, R3, -R4 ;
        /*0080*/                   MUFU.RSQ R2, R3 ;
        /*0090*/                   LDS R2, [R3+0x10] ;
        /*00a0*/                   STS [R3], R2 ;
        /*00b0*/                   LDG.E R2, desc[UR4][R2.64] ;
        /*00c0*/                   STG.E desc[UR4][R2.64], R5 ;
        /*00d0*/                   LDL R2, [R1+0x8] ;
        /*00e0*/                   STL [R1+0x8], R2 ;
        /*00f0*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0100*/                   SHFL.BFLY PT, R2, R3, 0x1, 0x1f ;
        /*0110*/              @!P0 BRA `(.L_x_1) ;
        /*0120*/                   IADD3 R2, R3, 0x1, RZ ;
        /*0130*/                   EXIT ;
        /*0140*/                   FFMA32I R2, R2, 0.25, R3 ;
\t\t..........
\t\tFunction : _Z11other_kernelv
        /*0000*/                   FFMA R1, R2, R3, R4 ;
"""


def test_count_kernel_ops_classes_a_hand_written_listing(tmp_path):
    assert CK.ffma_class("FFMA R12, R6, R12, R9") == "three_registers"
    assert CK.ffma_class("FFMA R10, R10, UR6, R9") == "uniform_or_constant"
    assert CK.ffma_class("FFMA R25, R7.reuse, R25, R8") == "reuse"
    path = tmp_path / "listing.sass"
    path.write_text(LISTING)
    record = CK.main(["--sass", str(path), "--slots"], device="cpu")
    assert record["kernel"] == "_Z9mk_kernel6MkArgs" and record["static_instructions"] == 21
    assert record["by_class"] == {"FFMA": 6, "FMUL": 1, "FADD": 1, "MUFU": 1, "LDS": 1, "STS": 1, "LDG": 1,
                                  "STG": 1, "LDL": 1, "STL": 1, "BAR": 1, "SHFL": 1, "branch": 2, "other": 2}
    assert record["ffma"] == {"count": 6, "three_registers": 1, "reuse": 1, "uniform_or_constant": 2,
                              "immediate_or_rz": 2, "three_register_share": 1 / 6}
    assert record["ldl_stl"] == 2 and "not weighted by loop trips" in record["note"]
    s = record["slots"]
    # (2 * 6 + 3) operations over 9 arithmetic instructions; one FFMA of 9 costs a second cycle
    assert s["ops_per_arith_instruction"] == pytest.approx(15 / 9)
    assert s["issue_cycles_per_arith_instruction"] == pytest.approx(10 / 9)
    want_s = s["f32_ops"] / (15 / 9) / 32 * (10 / 9) / (4 * 132 * 1.98e9)
    assert s["issue_bound_ms"] == pytest.approx(1e3 * want_s)
    assert s["speed_of_light_env_steps_per_s"] == pytest.approx(8192 / want_s)


def test_count_kernel_ops_reads_source_lines_from_nvdisasm():
    text = """
\t.section\t.text._Z9mk_kernel6MkArgs,"ax",@progbits
.text._Z9mk_kernel6MkArgs:
\t//## File "/x/csrc/megakernel.cuh", line 12
        /*0000*/                   FFMA R12, R6, R12, R9 ;
        /*0010*/                   FFMA R10, R10, UR6, R9 ;
\t//## File "/x/csrc/megakernel.cu", line 101
        /*0020*/                   EXIT ;
.text._Z11other_kernelv:
\t//## File "/x/csrc/megakernel.cuh", line 12
        /*0000*/                   FADD R1, R2, R3 ;
"""
    lines = CK.lines_census(text)
    assert lines[("megakernel.cuh", 12)] == {"FFMA": 2, "instructions": 2, "three_registers": 1}
    assert lines[("megakernel.cu", 101)] == {"branch": 1, "instructions": 1}
    assert len(lines) == 2


MOVED_WORK = {  # chip_smoke.megakernel_work before the move, 8192 envs x 10 substeps, 7.41 contacts, 5.49 limits
    "scene_flat_terrain_backlash": (18808832, 4761023283.2, 6981066752.0),
    "scene_flat_terrain": (15532032, 3196850995.2, 4104314880.0),
    "scene_rough_terrain_backlash": (19070976, 4882674483.2, 7102717952.0),
    "scene_flat_terrain_no_head": (12517376, 2703323955.2, 3266684518.4000006),
}


@pytest.mark.parametrize("scene", list(MOVED_WORK))
def test_moved_megakernel_work_gives_what_chip_smoke_gave(scene):
    m = loader.load_model(scene, device=CPU, dtype=torch.float32, timestep=0.002)
    got = CK.megakernel_work(m, 8192, 10, 7.41, 5.49)
    assert got == MOVED_WORK[scene]
    if scene == "scene_flat_terrain_backlash":
        assert f"{got[1]:.3g}" == "4.76e+09"  # PERF.md's operations per launch


def test_chip_smoke_takes_megakernel_work_from_the_census(monkeypatch):
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    monkeypatch.setitem(sys.modules, "chip_smoke", smoke)  # its dataclasses look their module up
    spec.loader.exec_module(smoke)
    assert not hasattr(smoke, "megakernel_work")
    P = smoke.load_modules()
    m = loader.load_model(device=CPU, dtype=torch.float32, timestep=0.002)
    assert P.CK.megakernel_work(m, 8192, 10, 7.41, 5.49) == MOVED_WORK["scene_flat_terrain_backlash"]
    assert P.CK.megakernel_work(m, 1024, 10, 7.41, 5.49, dense=True) == (2351104, 760196710.4000001, 872633344.0)


def test_gen_no_head_xml_writes_the_jax_tools_bytes(tmp_path):
    spec = importlib.util.spec_from_file_location("root_gen_no_head_xml", ROOT / "tools" / "gen_no_head_xml.py")
    root = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(root)
    xmls = ROOT / "open_duck_playground_tpu" / "models" / "open_duck_mini_v2" / "xmls"
    jax_out, port_out = tmp_path / "jax" / "open_duck_mini_v2_no_head.xml", tmp_path / "port.xml"
    jax_out.parent.mkdir()
    root.strip_head(xmls / "open_duck_mini_v2.xml", jax_out)
    record = gen_no_head_xml.main(["--out", str(port_out)], device="cpu")
    assert record["removed_bodies"] == 1 and record["removed_actuators"] == 4
    assert port_out.read_bytes() == jax_out.read_bytes() == (xmls / "open_duck_mini_v2_no_head.xml").read_bytes()


def test_measuring_tools_refuse_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for tool in (profile_step, profile_train_step, profile_epoch, profile_shuffle, profile_window, CK):
        with pytest.raises(SystemExit, match="no CUDA device"):
            tool.main([])


def test_coverage_counts_the_launches_whose_device_event_is_lost():
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    ev = lambda name, dev, i, start: types.SimpleNamespace(name=name, device_type=dev, id=i,
                                                           time_range=types.SimpleNamespace(start=start, end=start + 1))
    events = [ev("aten::add", cpu, 1, 0.0), ev("cudaLaunchKernel", cpu, 2, 10.0), ev("add_kernel", cuda, 2, 15.0),
              ev("cuLaunchKernel", cpu, 3, 20.0), ev("mk_kernel", cuda, 3, 18.5),
              ev("cudaMemsetAsync", cpu, 4, 30.0), ev("cudaLaunchKernel", cpu, 5, 40.0),
              ev("cudaStreamSynchronize", cpu, 6, 50.0)]
    assert benchutil.coverage(events) == {"launch_calls": 4, "untraced_launches": 2, "least_launch_to_start_us": -1.5}
    assert benchutil.coverage(events[:1]) == {"launch_calls": 0, "untraced_launches": 0,
                                              "least_launch_to_start_us": None}


def test_span_stats_places_launches_and_idle_gaps_by_the_innermost_span():
    cuda = torch.autograd.DeviceType.CUDA
    ev = lambda name, i, start, end: types.SimpleNamespace(name=name, device_type=cuda, id=i,
                                                           time_range=types.SimpleNamespace(start=start, end=end))
    launched = {1: 1.0, 2: 3.0, 3: 6.0, 4: 12.0, 5: 25.0, 6: 40.0}
    device = [ev("k_policy", 1, 2.0, 4.0), ev("k_wrapper", 2, 5.0, 6.0), ev("Memcpy HtoD", 3, 12.0, 12.5),
              ev("mk_kernel", 4, 13.0, 21.0), ev("late", 5, 26.0, 27.0), ev("outside", 6, 41.0, 42.0)]
    spans = {"policy": [(0.0, 2.0)], "env.wrapper": [(2.5, 20.0)], "env.physics": [(11.0, 14.0)]}
    out = benchutil.span_stats(spans, (0.0, 30.0), device, lambda e: launched[e.id], top=3)
    assert out["spans"] == {"policy": {"kernel_launches": 1, "copies": 0, "device_ms": pytest.approx(2e-3)},
                            "env.wrapper": {"kernel_launches": 1, "copies": 1, "device_ms": pytest.approx(1.5e-3)},
                            "env.physics": {"kernel_launches": 1, "copies": 0, "device_ms": pytest.approx(8e-3)},
                            "other": {"kernel_launches": 1, "copies": 0, "device_ms": pytest.approx(1e-3)}}
    assert out["launches_in_spans"] == 0.75
    assert out["idle_gaps"] == [["env.wrapper", pytest.approx(6e-3)], ["other", pytest.approx(5e-3)],
                                ["env.wrapper", pytest.approx(1e-3)]]


def test_profile_window_runs_its_control_step_on_the_cpu():
    record = profile_window.main(["--envs", "8", "--traces", "1"], device="cpu")
    assert record["tool"] == "profile_window" and record["envs"] == 8 and record["settings"] is None
    assert record["device"] == "cpu" and record["card"] == "cpu"
