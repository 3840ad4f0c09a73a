"""Serving with the ECI coherent prefix tier (paper Fig. 8 at the serving
layer): a repeated prompt skips prefill — its decode state is served from
the consumer-side coherent cache, with write-invalidate when the
published state changes.

    PYTHONPATH=src python -m repro_torch.examples.coherent_kv_serving \
        [--device cpu]

The port of ``examples/coherent_kv_serving.py``: smollm-360m's smoke
config, parameters and prompts drawn from seeds, on the card unless
``--device`` names another device.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import init_params
from repro_torch.serve import CoherentPrefixTier, ServeEngine
from repro_torch.serve.quantize import quantize_params


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    dev = resolve_device(ap.parse_args(argv).device)

    cfg = get_config("smollm-360m", smoke=True)
    params = init_params(cfg, generator=torch.Generator(dev).manual_seed(0),
                         device=dev)
    engine = ServeEngine(cfg, params, max_seq=64, device=dev)
    tier = CoherentPrefixTier(device=dev)

    prompts = torch.randint(0, cfg.vocab, (2, 12), device=dev,
                            generator=torch.Generator(dev).manual_seed(7))
    prefix = tuple(int(t) for t in prompts.reshape(-1))

    print("request 1 (cold): prefill 12 tokens + decode 8")
    t0 = time.monotonic()
    state, idx, lg = engine.prefill(prompts)
    tier.publish(prefix, (state, idx, lg))
    out1, _ = engine.decode(state, lg.argmax(-1), idx, 8)
    t_cold = time.monotonic() - t0

    print("request 2 (hot): prefill state from the coherent tier")
    t0 = time.monotonic()
    # decode copies the pooled state on entry, so the pool stays as
    # published.
    state2, idx2, lg2 = tier.lookup(prefix)
    out2, _ = engine.decode(state2, lg2.argmax(-1), idx2, 8)
    t_hot = time.monotonic() - t0

    if not bool((out1 == out2).all()):
        raise SystemExit("coherent-tier decode must be identical")
    print(f"  identical outputs: True; cold {t_cold*1e3:.0f} ms -> hot "
          f"{t_hot*1e3:.0f} ms ({t_cold/max(t_hot,1e-9):.1f}x)")
    print(f"  tier protocol traffic: {tier.store.interconnect_messages}")

    print("publisher updates the prefix -> consumer cache invalidated:")
    tier.publish(prefix, (state, idx, lg))
    _ = tier.lookup(prefix)
    print(f"  after republish: {tier.store.interconnect_messages}")

    print("\nbeyond-paper: int8 weight-only serving (same outputs check)")
    qparams = quantize_params(params, min_size=64, cfg=cfg)
    qengine = ServeEngine(cfg, qparams, max_seq=64, device=dev)
    qs, qi, qlg = qengine.prefill(prompts)
    outq, _ = qengine.decode(qs, qlg.argmax(-1), qi, 8)
    agree = float((outq == out1).float().mean())
    print(f"  int8 vs {cfg.dtype} token agreement: {agree:.2f} "
          f"(weight sweep halved for the memory-bound decode)")


if __name__ == "__main__":
    main()
