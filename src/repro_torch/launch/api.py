"""Uniform model API for the launchers (port of the step-function half of
``repro.launch.api``).

Dispatch on ``cfg.enc_dec``: the encoder-decoder (``models/encdec.py``:
whisper_medium, transformer_tiny) or the decoder LM
(``models/transformer.py``: dense, local, attn, moe, mamba1 and mamba2
patterns).

    params = api.init_params(cfg, seed=0, device="cuda")
    loss, metrics = api.make_loss_fn(cfg)(params, batch, policy)
    step, opt = api.make_train_step(cfg, policy)     # AdamW, cosine / WSD
    logits, caches = api.make_prefill_step(cfg, policy)(params, batch,
                                                        caches)
    logits, caches = api.make_decode_step(cfg, policy)(params, batch,
                                                       caches, index)

Batches use the reference's keys: ``tokens`` / ``labels`` for an LM,
``enc_inputs`` (frame embeddings [B, S, d] or token ids [B, S]) /
``dec_tokens`` / ``dec_labels`` for an encoder-decoder; ``dec_bos`` [B, 1]
at an enc-dec prefill (whose step takes no caches: it builds the decoder
caches for ``WHISPER_DEC_LEN`` tokens and returns them with the cross
K/V as its state) and ``token`` [B, 1] at decode.  The reference's
ShapeDtypeStruct and PartitionSpec half (``param_struct``,
``batch_struct``, ``cache_struct``, ``param_pspecs``, ``cache_pspecs``,
``batch_pspecs``) belongs with the port's parallel layer and is not here.
"""
from __future__ import annotations

from typing import Callable, Tuple

from repro_torch.configs.base import ArchConfig
from repro_torch.core.policy import Policy
from repro_torch.models import encdec
from repro_torch.models import transformer as tlm
from repro_torch.optim import optimizers, schedules

WHISPER_DEC_LEN = 448


def init_params(cfg: ArchConfig, seed: int = 0, device=None):
    """Random params of ``cfg`` from ``seed`` on ``device`` (the card
    unless the caller asks for the CPU)."""
    if cfg.enc_dec:
        return encdec.init_encdec(cfg, seed=seed, device=device)
    return tlm.init_lm(cfg, seed=seed, device=device)


def make_loss_fn(cfg: ArchConfig) -> Callable:
    """``loss(params, batch, policy) -> (loss, metrics)``."""
    if cfg.enc_dec:
        def loss(params, batch, pol):
            return encdec.loss_fn(params, batch["enc_inputs"],
                                  batch["dec_tokens"], batch["dec_labels"],
                                  cfg, pol)
        return loss

    def loss(params, batch, pol):
        return tlm.loss_fn(params, batch["tokens"], batch["labels"], cfg, pol)
    return loss


def make_train_step(cfg: ArchConfig, policy: Policy, lr: float = 1e-4
                    ) -> Tuple[Callable, optimizers.Optimizer]:
    """(train step, AdamW) as the reference's: weight decay 0.01, the
    config's WSD or cosine schedule over 10,000 steps with 100 of warmup;
    the step is ``training.trainer.make_train_step``'s (params, opt_state,
    batch, step) -> (params, opt_state, metrics)."""
    from repro_torch.training.trainer import make_train_step as mk
    opt = optimizers.adamw(weight_decay=0.01)
    sched = schedules.make_schedule(
        cfg.schedule if cfg.schedule in ("wsd", "cosine") else "cosine",
        lr, total_steps=10_000, warmup=100)
    return mk(make_loss_fn(cfg), opt, sched, policy), opt


def make_prefill_step(cfg: ArchConfig, policy: Policy) -> Callable:
    if cfg.enc_dec:
        def step(params, batch):
            return encdec.serve_prefill(params, batch["enc_inputs"],
                                        batch["dec_bos"], cfg, policy,
                                        max_dec_len=WHISPER_DEC_LEN)
        return step

    def step(params, batch, caches):
        return tlm.prefill(params, batch["tokens"], cfg, policy, caches)
    return step


def make_decode_step(cfg: ArchConfig, policy: Policy) -> Callable:
    if cfg.enc_dec:
        def step(params, batch, state, cache_index):
            return encdec.serve_decode(params, batch["token"], state,
                                       cache_index, cfg, policy)
        return step

    def step(params, batch, caches, cache_index):
        return tlm.decode_step(params, batch["token"], cfg, policy, caches,
                               cache_index)
    return step
