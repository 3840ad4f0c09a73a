"""Serving driver: batched greedy generation behind the coherent prefix
tier.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \\
        --smoke --batch 4 --prompt-len 16 --new-tokens 24 --repeat 3 \\
        [--device cpu]

The port of ``repro.launch.serve``.  ``--repeat`` submits the same
prompts again: the ``CoherentPrefixTier`` serves their prefill state
from the consumer-side coherent cache (paper Fig. 8), and the driver
prints each request's latency, the tier's hit rate and its interconnect
messages.  Parameters and prompts are drawn from seeds; ``--device``
defaults to ``cuda``.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from ..configs import get_config
from ..device import resolve_device
from ..models import init_params
from ..serve import CoherentPrefixTier, ServeEngine


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=24)
    ap.add_argument("--repeat", type=int, default=3)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    if cfg.encoder is not None:
        raise SystemExit("enc-dec serving needs frames; use an LM arch here")
    params = init_params(cfg, generator=torch.Generator(
        device=dev).manual_seed(0), device=dev)
    max_seq = args.prompt_len + args.new_tokens + 1
    engine = ServeEngine(cfg, params, max_seq=max_seq, device=dev)
    tier = CoherentPrefixTier(device=dev)

    prompts = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                            generator=torch.Generator(device=dev
                                                      ).manual_seed(7),
                            device=dev, dtype=torch.int32)
    prefix_key = tuple(int(t) for t in prompts.reshape(-1))

    for it in range(args.repeat):
        t0 = time.monotonic()
        cached = tier.lookup(prefix_key)
        if cached is not None:
            # the prefill state served from the coherent tier (decode
            # copies it, so the pool keeps it as published).
            state, idx, lg = cached
            prefill_tokens = 0
        else:
            state, idx, lg = engine.prefill(prompts)
            tier.publish(prefix_key, (state, idx, lg))
            prefill_tokens = args.prompt_len
        out, _ = engine.decode(state, lg.argmax(-1).to(torch.int32), idx,
                               args.new_tokens)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        print(json.dumps({"iter": it, "prefill_tokens": prefill_tokens,
                          "latency_s": round(time.monotonic() - t0, 3),
                          "tier_hit_rate": round(tier.hit_rate, 3)}))

    print(json.dumps({"arch": cfg.name, "device": str(dev),
                      "tokens": list(out.shape),
                      "tier_messages": tier.store.interconnect_messages},
                     default=str))


if __name__ == "__main__":
    main()
