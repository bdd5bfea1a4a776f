"""The plain reference agrees with the program's plain path (its CPU path)
at a tiny depth and width, in fp32: the eval features, and the losses,
first gradients and parameters of train steps driven from one seed, which
shows that the reference works out the step's random draws again."""

import copy

import pytest
import torch

from benchmark import inputs, program
from benchmark.harness import Run
from benchmark.reference import editor as ref
from benchmark.tests.tiny import tiny_cell


def parity_cell(name: str, stride: int):
    """A tiny cell in fp32 at 128 x 64 with HEAD_KEEP 1, so the program's
    compact tail drops rows (23 of 32 patches kept at stride 16)."""
    cell = tiny_cell(name)
    cfg = copy.deepcopy(cell.config)
    cfg["model"].update(img_size=[128, 64], stride_size=[stride, stride], head_keep=1)
    over = {"TPU.COMPUTE_DTYPE": "float32", "INPUT.SIZE_TRAIN": "[128, 64]",
            "INPUT.SIZE_TEST": "[128, 64]", "MODEL.HEAD_KEEP": "1",
            "MODEL.STRIDE_SIZE": f"[{stride}, {stride}]"}
    load = dict(zip(cfg["load_config"][0::2], cfg["load_config"][1::2]), **over)
    cfg["load_config"] = [x for kv in load.items() for x in kv]
    cell.config = cfg
    return cell


@pytest.mark.parametrize("stride", [16, 12])
def test_eval_features_match_the_programs_plain_path(stride):
    cell = parity_cell("rgbnt201.eval", stride)
    run = Run(cell, 3, 1.0, False, "cpu", 0.0)
    s, cfg = run.shape, cell.config
    split = inputs.eval_split(cell.traffic, cfg, 4, "cpu")
    P = inputs.make_weights(s, 5, "cpu")
    pcfg = program.config(cfg)
    model = program.build_model(cfg, pcfg, P, inputs.make_buffers(s, "cpu"), "cpu")
    assert model.cfg.compact_tail and s.P > 23
    tf = program.eval_transform(pcfg)
    imgs = {k: tf(split[k][:8]) for k in ref.MODS}
    with torch.no_grad():
        got = model(imgs, cam_ids=split["camid"][:8], training=False)
        want = ref.forward(P, inputs.make_buffers(s, "cpu"), imgs, split["camid"][:8], s,
                           ref.Arith())
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("stride", [16, 12])
def test_train_steps_match_the_programs_plain_path(stride):
    cell = parity_cell("rgbnt201.train", stride)
    run = Run(cell, 3, 1.0, False, "cpu", 0.0)
    s, cfg, tf = run.shape, cell.config, cell.traffic
    split = inputs.train_split(tf, cfg, 7, "cpu")
    plan = inputs.pk_plan(split["pid"].numpy(), tf["ids_per_batch"], tf["instances"], 2, 9)
    batches = [{k: split[k][torch.as_tensor(i)] for k in ref.MODS + ("pid", "camid")}
               for i in plan]
    start = inputs.make_weights(s, 5, "cpu")
    pcfg = program.config(cfg)
    model = program.build_model(cfg, pcfg, start, inputs.make_buffers(s, "cpu"), "cpu")
    step, opt = program.train_step(pcfg, cfg, model, seed=11)
    losses = []
    for i, b in enumerate(batches):
        losses.append(float(step(b, 1)["loss"]))
        if i == 0:
            momentum = program.momentum_by_name(model, opt)
    P = {n: w.clone().requires_grad_(not ref.frozen(n)) for n, w in start.items()}
    ref_losses, g1 = ref.train_steps(P, inputs.make_buffers(s, "cpu"), batches, [1, 1], 11, s,
                                     cfg, ref.Arith())
    assert losses == pytest.approx(ref_losses, rel=1e-5)
    for n, p in model.named_parameters():
        if ref.frozen(n):
            continue
        wd = ref.group_of(n, cfg["solver"])[1]
        g = g1.get(n, torch.zeros_like(p))
        torch.testing.assert_close(momentum[n] - wd * start[n], g, rtol=1e-4, atol=1e-6)
        torch.testing.assert_close(p.detach(), P[n].detach(), rtol=1e-5, atol=1e-6)
