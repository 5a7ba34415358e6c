"""Batched serving driver: prefill a batch of prompts, then decode with a
static-batch KV cache (the port of ``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \\
        --batch 4 --prompt-len 32 --gen 16 [--temperature 0.8] \\
        [--device cpu]

``--reduced`` is always on, as in the reference.  Greedy decoding by
default; ``--temperature`` samples with ``torch.multinomial`` from an
explicit generator.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.core.snap import resolve_device
from repro_torch.models.transformer import (cast_for_compute, decode_step,
                                            init_cache, init_params, prefill,
                                            tree_leaves, tree_map)


def widen_cache(cfg, pcache, B: int, total: int):
    """The decode cache: the prefill cache written into buffers ``total``
    positions long (a leaf that already fits is kept as is).

    Cross-attention K/V keep their own length (nothing is written into
    them).  A prefill entry wider than its decode buffer raises: a local
    layer's prefill cache is ``sliding_window`` wide when the prompt is
    shorter than the window, while its buffer is min(window, P + gen);
    the reference's negative pad fails there too."""
    dev = tree_leaves(pcache)[0][1].device
    s_cross = pcache['cross_k'].shape[2] if 'cross_k' in pcache else None
    full = init_cache(cfg, B, total, s_cross=s_cross, device=dev)
    out = {}
    for key in full:
        dst, src = full[key], pcache[key]
        if isinstance(dst, dict):
            out[key] = {k: _widen(cfg, f'{key}.{k}', dst[k], src[k])
                        for k in dst}
        else:
            out[key] = _widen(cfg, key, dst, src)
    return out


def _widen(cfg, path, dst, src):
    if dst.shape == src.shape:
        return src
    if any(s > d for s, d in zip(src.shape, dst.shape)):
        raise ValueError(
            f'{cfg.name}: prefill cache {path} of shape {tuple(src.shape)} '
            f'does not fit its decode buffer {tuple(dst.shape)}: a local '
            f'layer of window {cfg.sliding_window} needs prompt + gen >= '
            'the window')
    dst[tuple(slice(0, n) for n in src.shape)].copy_(src)
    return dst


def generate(cfg, params, prompts, gen: int, frontend=None,
             temperature: float = 0.0, generator=None, device='cuda'):
    """Prefill ``prompts`` [B, P] and decode ``gen`` tokens on ``device``
    (the card unless the CPU is asked for; without a card 'cuda' raises).

    ``params`` may be float32 master weights: they are moved to ``device``
    (a no-op where they are) and cast to the compute dtype once, before
    the prefill.  Greedy (argmax) unless
    ``temperature`` > 0, which samples with ``torch.multinomial`` from
    ``generator``.  The tokens stay on the device between steps; the host
    clock around the prefill and around the decode loop ends in a
    synchronize on the card.  Returns a dict: ``tokens`` [B, gen],
    ``last_logits`` (the prefill's), ``logits`` (the last decode step's),
    ``prefill_s``, ``decode_s``.
    """
    dev = resolve_device(device)
    sync = (torch.cuda.synchronize if dev.type == 'cuda' else lambda: None)
    prompts = prompts.to(dev)
    frontend = None if frontend is None else frontend.to(dev)
    B, P = prompts.shape
    params = cast_for_compute(tree_map(lambda t: t.to(dev), params),
                              cfg.adtype)
    sync()
    t0 = time.perf_counter()
    last_logits, pcache = prefill(cfg, params, prompts,
                                  frontend_embeds=frontend)
    cache = widen_cache(cfg, pcache, B, P + gen)
    del pcache
    sync()
    t_prefill = time.perf_counter() - t0

    def pick(logits):
        if temperature > 0:
            probs = torch.softmax(logits[:, 0].float() / temperature, -1)
            return torch.multinomial(probs, 1, generator=generator)
        return torch.argmax(logits, -1)

    tok = pick(last_logits)
    out_tokens = [tok]
    logits = last_logits
    t0 = time.perf_counter()
    for i in range(gen - 1):
        logits, cache = decode_step(cfg, params, cache, tok, P + i)
        tok = pick(logits)
        out_tokens.append(tok)
    sync()
    return dict(tokens=torch.cat(out_tokens, dim=1), last_logits=last_logits,
                logits=logits, prefill_s=t_prefill,
                decode_s=time.perf_counter() - t0)


def random_inputs(cfg, B: int, P: int, generator, device):
    """(prompts [B, P], frontend embeddings or None) as the reference's
    serve makes them: audio frames [B, P, d] for an encoder, vision
    patches [B, n_frontend_tokens, d] for a VLM; drawn on the generator's
    device."""
    g = generator.device
    prompts = torch.randint(0, cfg.vocab, (B, P), generator=generator,
                            device=g).to(device)
    frontend = None
    if cfg.frontend == 'audio' or cfg.enc_layers:
        frontend = torch.randn((B, P, cfg.d_model), generator=generator,
                               device=g).to(device)
    elif cfg.frontend == 'vision':
        frontend = torch.randn((B, cfg.n_frontend_tokens, cfg.d_model),
                               generator=generator, device=g).to(device)
    return prompts, frontend


def main(argv=None):
    ap = argparse.ArgumentParser(prog='python -m repro_torch.launch.serve')
    ap.add_argument('--arch', required=True)
    ap.add_argument('--reduced', action='store_true', default=True)
    ap.add_argument('--batch', type=int, default=4)
    ap.add_argument('--prompt-len', type=int, default=32)
    ap.add_argument('--gen', type=int, default=16)
    ap.add_argument('--temperature', type=float, default=0.0)
    ap.add_argument('--device', default='cuda', choices=('cuda', 'cpu'))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(cfg, gen, device=dev)
    B, P, G = args.batch, args.prompt_len, args.gen
    prompts, frontend = random_inputs(cfg, B, P, gen, dev)

    with torch.inference_mode():
        out = generate(cfg, params, prompts, G, frontend=frontend,
                       temperature=args.temperature, generator=gen,
                       device=dev)
    t_prefill, t_decode = out['prefill_s'], out['decode_s']
    tokens = out['tokens'].cpu()
    print(f'arch={cfg.name} B={B} prompt={P} gen={G}')
    print(f'prefill: {t_prefill * 1e3:.1f} ms '
          f'({B * P / max(t_prefill, 1e-9):.0f} tok/s)')
    print(f'decode : {t_decode * 1e3:.1f} ms '
          f'({B * (G - 1) / max(t_decode, 1e-9):.1f} tok/s)')
    print('sample generations (token ids):')
    for b in range(min(B, 2)):
        print(f'  [{b}]', tokens[b, :12].tolist())
    return out


if __name__ == '__main__':
    main()
