"""The `train_batches` traffic: the port's train step (`make_train_step`
with `ModuleAdam` at the configuration's settings) over a pool of seeded
batches on the device, one step a batch, each step's loss read back.

Set-up builds one step object, drives it from the seed through its first
three steps (on batches 0, 1 and 2 of the pool, so every row differs)
and hands that same object to the window. Some `LATE_LEAD` steps before
the window closes (by the last step's time) the run copies the weights,
buffers and Adam's state, and checks the three timed steps that follow
as it checked the first three. After the window has closed the reference
follows the first three steps from the seed's weights, and the late
three from that copy: the program's own state, so the first three check
the start and the late three the steps the window times."""

from __future__ import annotations

import copy
import math
import time

import torch

from bench import compare, port, synth, trace
from reference.losses import LossConfig as RefLossConfig
from reference.poco import POCO as RefPOCO
from reference.train import Adam as RefAdam
from reference.train import smpl_from_arrays
from reference.train import train_step as ref_train_step

END_TO_END = ("setup_s", "train_crops_per_s")
READINGS = tuple(p + k for p in ("", "late_") for k in ("loss_rel", "loss1_rel", "grad_leaf",
                                                        "update_leaf", "update_median"))
PRECISIONS = ("fp32",)
CELL_KEYS = ()
CHECKED_STEPS = 3
CALIBRATION_CROPS = 16
LATE_LEAD = 6            # steps before the window's end at which the late check starts
LATE_SEED = 1000         # step_seed's index of the first late step
CONTROL_WARM_STEPS = 128  # about the steps a 51-s window runs before its late ones


def check(cell: dict) -> list[str]:
    opt = cell["config_data"].get("optimizer", {})
    if opt.get("weight_decay") or opt.get("grad_clip"):
        return ["the reference's Adam has no weight decay and no clipping"]
    return []


def step_seed(seed: int, k: int) -> int:
    """The seed of torch's generators before checked step k (dropout masks)."""
    return (int(seed) * 1000003 + k) % 2**63


def checked_seeds(seed: int, late: bool = False) -> list[int]:
    first = LATE_SEED if late else 0
    return [step_seed(seed, first + k) for k in range(CHECKED_STEPS)]


def inputs(ctx) -> dict:
    dev, traffic, cfg = ctx.device, ctx.traffic, ctx.config
    gen = synth.generator(ctx.seed, dev)
    arrays = synth.smpl_arrays(gen, dev, cfg["smpl"]["num_verts"], cfg["smpl"]["num_faces"])
    ref_smpl = smpl_from_arrays(arrays)
    batches = synth.train_batches(gen, dev, traffic, cfg["model"], ref_smpl)
    calib = batches[0]["img"][:CALIBRATION_CROPS].permute(0, 3, 1, 2)
    ref = synth.reference_model(RefPOCO, synth.ref_config(cfg["model"]), ctx.seed, dev, calib)
    return {"arrays": arrays, "ref_smpl": ref_smpl, "batches": batches, "ref": ref}


def ref_loss_config(config: dict) -> RefLossConfig:
    return RefLossConfig(**{k: tuple(v) if isinstance(v, list) else v
                            for k, v in config["loss"].items()})


def reference_adam(ref, config: dict, state: dict | None = None) -> RefAdam:
    """The reference's Adam over `ref` at the configuration's settings,
    fresh, or holding `state` (`exp_avg`, `exp_avg_sq` by leaf name and
    `steps`, as `snapshot` and `adam_snapshot` keep them)."""
    opt = config["optimizer"]
    adam = RefAdam(ref.parameters(), lr=opt["lr"], betas=tuple(opt["betas"]), eps=opt["eps"])
    if state is not None:
        names = [n for n, _ in ref.named_parameters()]
        adam.steps = state["steps"]
        for key, moments in (("exp_avg", adam.m), ("exp_avg_sq", adam.v)):
            for i, n in enumerate(names):
                if n in state[key]:
                    moments[i] = state[key][n].detach().clone()
    return adam


def adam_snapshot(ref, adam: RefAdam) -> dict:
    names = [n for n, _ in ref.named_parameters()]
    return {"exp_avg": dict(zip(names, adam.m)), "exp_avg_sq": dict(zip(names, adam.v)),
            "steps": adam.steps}


def reference_steps(ref, adam, ref_smpl, batches, config, seeds, batch_rows=None):
    """The reference's steps from its weights and Adam's state as they
    are, one a batch of `batches`, torch's generators at the seed of
    `seeds` in the same place: (losses, the first step's gradient norms
    by leaf, the change norms by leaf after the last step). `batch_rows`
    keeps only the first rows of each batch."""
    start = {k: p.detach().clone() for k, p in ref.named_parameters()}
    loss_cfg = ref_loss_config(config)
    losses, grad = [], {}
    for k, (batch, seed) in enumerate(zip(batches, seeds)):
        if batch_rows is not None:
            batch = {key: v[:batch_rows] for key, v in batch.items()}
        torch.manual_seed(seed)
        terms = ref_train_step(ref, adam, batch, ref_smpl, loss_cfg)
        losses.append(terms["loss/total_loss"].item())
        if k == 0:
            grad = {n: float(p.grad.norm()) if p.grad is not None else 0.0
                    for n, p in ref.named_parameters()}
    update = {n: float((p.detach() - start[n]).norm()) for n, p in ref.named_parameters()}
    return losses, grad, update


def snapshot(model, optimizer) -> dict:
    """Copies of the port's weights and buffers and of Adam's moments, and
    Adam's step count."""
    state = port.adam_state(model, optimizer)
    return {"weights": {k: v.detach().clone() for k, v in model.state_dict().items()},
            "exp_avg": {n: s["exp_avg"].clone() for n, s in state.items()},
            "exp_avg_sq": {n: s["exp_avg_sq"].clone() for n, s in state.items()},
            "steps": int(next(iter(state.values()))["step"]) if state else 0}


def leaf_norms(left: list, right: list, alpha: float = 1.0) -> torch.Tensor | None:
    """‖left - alpha * right‖ of each pair, in one tensor on the device (no
    wait for the host)."""
    if not left:
        return None
    return torch.stack(torch._foreach_norm(torch._foreach_sub(left, right, alpha=alpha)))


def host_norms(names: list[str], norms: torch.Tensor | None, scale: float = 1.0) -> dict:
    return {} if norms is None else {n: v * scale for n, v in zip(names, norms.tolist())}


def run(ctx) -> dict:
    dev, cfg, traffic = ctx.device, ctx.config, ctx.traffic
    made = inputs(ctx)
    batches, ref, ref_smpl = made["batches"], made["ref"], made["ref_smpl"]
    ctx.mark("inputs and the reference model made")
    model = port.build_model(cfg["model"], ref.state_dict(), dev)
    smpl = port.load_smpl(*synth.write_smpl_files(made["arrays"], ctx.tmpdir), dev)
    ctx.mark("the port's model and SMPL loaded")
    ref.to("cpu")   # off the card while the port runs
    step, optimizer = port.train_step(model, cfg)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    beta1 = cfg["optimizer"]["betas"][0]

    ctx.mark("optimizer and step built")
    losses, grad, update = [], {}, {}
    pace = [0.0]   # the last step's seconds
    for k, seed in enumerate(checked_seeds(ctx.seed)):
        torch.manual_seed(seed)
        t = time.perf_counter()
        losses.append(float(step(batches[k], smpl)["loss/total_loss"]))
        pace[0] = time.perf_counter() - t
        if k == 0:
            grad = {n: float(s["exp_avg"].norm()) / (1.0 - beta1)
                    for n, s in port.adam_state(model, optimizer).items()}
    for n, p in model.named_parameters():
        update[n] = float((p.detach() - start[n]).norm())
    del start
    ctx.sync()
    setup_s = time.perf_counter() - ctx.t_start

    ctx.mark("three checked steps done")
    counter = {"next": CHECKED_STEPS}
    done, failed = [], 0
    late = {"losses": [], "seeds": checked_seeds(ctx.seed, late=True)}

    def late_step(i: int, check_late: bool) -> int:
        """Which late checked step step i is (-1 for none); the copy is
        taken before the first."""
        if check_late and "first" not in late and (
                time.perf_counter() + LATE_LEAD * pace[0] >= t0 + ctx.seconds):
            late.update(first=i, snap=snapshot(model, optimizer))
        k = i - late.get("first", i + 1)
        return k if 0 <= k < CHECKED_STEPS else -1

    def checked(k: int, loss: float) -> None:
        snap = late["snap"]
        late["losses"].append(loss)
        if k == 0:
            state = port.adam_state(model, optimizer)
            late["grad_names"] = [n for n in snap["exp_avg"] if n in state]
            late["grad"] = leaf_norms([state[n]["exp_avg"] for n in late["grad_names"]],
                                      [snap["exp_avg"][n] for n in late["grad_names"]], beta1)
        if k == CHECKED_STEPS - 1:
            params = dict(model.named_parameters())
            late["update_names"] = list(params)
            late["update"] = leaf_norms([p.detach() for p in params.values()],
                                        [snap["weights"][n] for n in params])

    def train(stop, check_late=False):
        nonlocal failed
        while not stop():
            i = counter["next"]
            counter["next"] += 1
            k = late_step(i, check_late)
            if k >= 0:
                torch.manual_seed(late["seeds"][k])
            t = time.perf_counter()
            loss = float(step(batches[i % len(batches)], smpl)["loss/total_loss"])
            pace[0] = time.perf_counter() - t
            if k >= 0:
                checked(k, loss)
            failed += not math.isfinite(loss)
            done.append(time.perf_counter())

    t0 = time.perf_counter()
    summary = None
    if ctx.trace:
        train(lambda: len(done) >= 1)
        first = counter["next"]
        summary = trace.profile_stretch(
            lambda: train(lambda: counter["next"] >= first + ctx.cell["trace_calls"]), dev)
    after, done_before = time.perf_counter(), len(done)
    train(lambda: (time.perf_counter() - t0 >= ctx.seconds
                   and len(late["losses"]) == CHECKED_STEPS), check_late=True)
    ctx.sync()
    memory_peak = ctx.memory_peak()
    window_s = done[-1] - t0
    late_grad = host_norms(late["grad_names"], late["grad"], 1.0 / (1.0 - beta1))
    late_update = host_norms(late["update_names"], late["update"])
    snap = late.pop("snap")
    del model, smpl, step, optimizer, late["grad"], late["update"]
    ctx.free()

    ctx.mark("window closed, the port freed")
    ref.to(dev)
    first_batches = [batches[k] for k in range(CHECKED_STEPS)]
    ref_first = reference_steps(ref, reference_adam(ref, cfg), ref_smpl, first_batches, cfg,
                                checked_seeds(ctx.seed))
    readings = compare.train_readings(*zip_readings((losses, grad, update), ref_first))
    ref.load_state_dict(snap["weights"])
    adam = reference_adam(ref, cfg, snap)
    del snap
    late_batches = [batches[(late["first"] + k) % len(batches)] for k in range(CHECKED_STEPS)]
    ref_late = reference_steps(ref, adam, ref_smpl, late_batches, cfg, late["seeds"])
    readings.update(compare.prefixed("late_", compare.train_readings(
        *zip_readings((late["losses"], late_grad, late_update), ref_late))))
    if summary:
        loss_cfg = ref_loss_config(cfg)
        summary.update(
            requests=ctx.cell["trace_calls"], rows=ctx.cell["trace_calls"] * traffic["batch"],
            flops_per_call=trace.count_flops(lambda: ref_train_step(ref, adam, batches[0],
                                                                    ref_smpl, loss_cfg)),
            skinning_backward_shape=(traffic["batch"], cfg["smpl"]["num_verts"]),
            calls_per_s=(len(done) - done_before) / (done[-1] - after))
    return {
        "attempted": counter["next"] - CHECKED_STEPS,
        "failed": failed,
        "e2e": {"setup_s": setup_s, "train_crops_per_s": len(done) * traffic["batch"] / window_s},
        "summary": summary,
        "readings": readings,
        "memory_peak_bytes": memory_peak,
        "requests": len(done),
    }


def control(ctx) -> dict:
    """The readings of the reference in TF32 (the precision below fp32
    with TF32 off) and of the fault of half the batch left out, each in
    the port's place against the reference in fp32: over the first three
    steps, and over three late ones from the state after
    `CONTROL_WARM_STEPS` steps of the reference in fp32."""
    made = inputs(ctx)
    ref, smpl, batches, cfg = made["ref"], made["ref_smpl"], made["batches"], ctx.config

    def steps(model, adam, first, seeds, tf32=False, rows=None):
        picked = [batches[(first + k) % len(batches)] for k in range(len(seeds))]
        synth.tf32(tf32)
        try:
            return reference_steps(model, adam, smpl, picked, cfg, seeds, batch_rows=rows)
        finally:
            synth.tf32(False)

    def fresh():
        model = copy.deepcopy(ref)
        return model, reference_adam(model, cfg)

    def warm():
        model = copy.deepcopy(warmed)
        return model, reference_adam(model, cfg, adam_snapshot(warmed, warmed_adam))

    base = steps(*fresh(), 0, checked_seeds(ctx.seed))
    warmed, warmed_adam = fresh()
    steps(warmed, warmed_adam, 0, [step_seed(ctx.seed, k) for k in range(CONTROL_WARM_STEPS)])
    late_seeds = checked_seeds(ctx.seed, late=True)
    late_base = steps(*warm(), CONTROL_WARM_STEPS, late_seeds)
    out = {}
    for name, tf32, rows in (("control", True, None),
                             ("half_batch", False, ctx.traffic["batch"] // 2)):
        early = steps(*fresh(), 0, checked_seeds(ctx.seed), tf32, rows)
        late = steps(*warm(), CONTROL_WARM_STEPS, late_seeds, tf32, rows)
        out[name] = {**compare.train_readings(*zip_readings(early, base)),
                     **compare.prefixed("late_", compare.train_readings(
                         *zip_readings(late, late_base)))}
    return out


def zip_readings(program, reference) -> tuple:
    """`train_readings`' arguments from two `reference_steps` results."""
    return program[0], reference[0], program[1], reference[1], program[2], reference[2]
