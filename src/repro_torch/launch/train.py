"""Training driver: the train-step factory and the CLI entry point with
checkpoint/restart and deterministic data.

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --reduced --steps 20

The port's copy of the JAX package's ``launch/train.py``.  ``--device``
picks where the model lives: ``cuda`` (the default) trains on the card
and fails without one; ``cpu`` runs the kernels' plain versions.
Weights come from ``model.init`` with a seeded ``torch.Generator`` on
the device (``--seed``), batches from ``SyntheticLM`` (a pure function
of the step), and checkpoints (``--ckpt-every``, written on a
background thread) hold the whole optimizer state, so ``--resume``
continues from the latest one where the run left off.  ``main`` takes
``argv`` and returns the final metrics, so a caller can run it
in-process.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs import get_config, reduced
from repro_torch.models.api import ModelBase
from repro_torch.models.registry import build_model
from repro_torch.train.optimizer import (OptConfig, _recip, apply_updates,
                                         init_state, tree_leaves, tree_map)


def _rebuild(tree, leaves):
    """``tree`` with its leaves replaced, in ``tree_leaves`` order, by
    the next items of the iterator ``leaves``."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves) for k, v in tree.items()}
    return next(leaves)


def grad_of(model: ModelBase, params, batch):
    """(metrics, grads) of ``model.loss`` at ``params``: every leaf's
    gradient in the leaf's dtype (zeros for a leaf the loss does not
    reach, as ``jax.value_and_grad`` gives)."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    loss, metrics = model.loss(_rebuild(params, iter(leaves)), batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return metrics, _rebuild(params, iter(grads))


def make_train_step(model: ModelBase, opt_cfg: OptConfig, n_micro: int = 1
                    ) -> Callable:
    """-> train_step(state, batch) -> (new state, metrics): the loss's
    gradients, then one ``apply_updates``.  ``n_micro > 1``: gradient
    accumulation over ``n_micro`` equal splits of the batch, the grads
    summed in fp32 and divided by ``n_micro`` (as the jitted reference:
    times fl32(1 / n_micro)); the metrics are the last split's."""

    def train_step(state: Dict, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[Dict, Dict[str, torch.Tensor]]:
        if n_micro == 1:
            metrics, grads = grad_of(model, state["params"], batch)
        else:
            gsum = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device),
                state["params"])
            for i in range(n_micro):
                mb = {k: v.reshape(n_micro, v.shape[0] // n_micro,
                                   *v.shape[1:])[i]
                      for k, v in batch.items()}
                metrics, g = grad_of(model, state["params"], mb)
                gsum = tree_map(lambda a, x: a + x.to(torch.float32), gsum,
                                g)
            grads = tree_map(lambda a: a * _recip(n_micro), gsum)
        new_state, opt_metrics = apply_updates(state, grads, opt_cfg)
        return new_state, {**metrics, **opt_metrics}

    return train_step


def batch_to(batch, device) -> Dict[str, torch.Tensor]:
    """A ``SyntheticLM`` batch (int32 numpy) -> int64 tensors on
    ``device``."""
    return {k: torch.from_numpy(v).to(device=device, dtype=torch.int64)
            for k, v in batch.items()}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--reduced", action="store_true",
                    help="train the smoke-sized config")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights' torch.Generator")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--quantized-opt", action="store_true")
    return ap.parse_args(argv)


def main(argv=None, wrap_step: Optional[Callable] = None) -> Dict:
    """Train ``--steps`` steps (from the latest checkpoint with
    ``--resume``), printing every 10th.  ``wrap_step(step_fn)`` returns
    the step function the loop calls in ``step_fn``'s place (a caller
    times, counts or profiles the steps through it).  -> the final
    metrics as floats, with "step" (the steps taken in all) and "losses"
    (this run's loss at each step it took)."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.train.checkpoint import (flush, latest_step, restore,
                                              save_async)

    args = parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    cfg = cfg.with_overrides(max_seq=max(cfg.max_seq, args.seq))
    model = build_model(cfg, device=args.device)
    opt_cfg = OptConfig(lr=args.lr, quantized=args.quantized_opt)
    step_fn = make_train_step(model, opt_cfg)
    if wrap_step is not None:
        step_fn = wrap_step(step_fn)
    data = SyntheticLM(vocab=cfg.vocab, seq=args.seq, batch=args.batch,
                       n_shards=1, shard=0)

    start = 0
    if args.resume and (s := latest_step(args.ckpt_dir)) is not None:
        state = restore(args.ckpt_dir, s, device=model.device)
        start = int(state["step"])
        print(f"[train] resumed from step {start}")
    else:
        params = model.init(
            torch.Generator(device=model.device).manual_seed(args.seed))
        state = init_state(params, opt_cfg)

    t0 = time.time()
    metrics, losses = {}, []
    for step in range(start, args.steps):
        state, metrics = step_fn(
            state, batch_to(data.batch_for_step(step), model.device))
        losses.append(float(metrics["loss"]))
        if step % 10 == 0 or step == args.steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            print(f"[train] step {step:5d} loss={m['loss']:.4f} "
                  f"acc={m['acc']:.3f} gnorm={m['grad_norm']:.2f} "
                  f"({time.time() - t0:.1f}s)")
        if args.ckpt_every and (step + 1) % args.ckpt_every == 0:
            save_async(args.ckpt_dir, step + 1, state)
    flush()
    out = {k: float(v) for k, v in metrics.items()}
    out.update(step=args.steps, losses=losses)
    if losses:
        print(f"[train] done; final loss {losses[-1]}")
    return out


if __name__ == "__main__":
    main()
