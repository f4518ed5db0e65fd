"""Serving example on the PyTorch port: batched requests through the
continuous-batching engine whose paged-KV directory is a HiStore index
group.

    python examples/serve_kv_cache_torch.py [--device cpu]

The port's counterpart of ``examples/serve_kv_cache.py``, the same model
(tiny mistral-nemo: 4 GQA layers, d_model 128, random weights from a
generator seeded with 0), the same two waves of requests and the same
lines.  Shows continuous batching over decode_step, page registration
(PUT), SCAN-based page reclamation on sequence completion, and
prefix-reuse GET hits when prompts repeat.  It runs on the card (the
directory's CUDA kernels) unless ``--device`` names another device.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs.tiny import tiny_config  # noqa: E402
from repro_torch.models.transformer import init_params  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402

ENGINE = dict(batch_slots=4, max_len=96, page_size=8)
WAVE1 = [[1, 2, 3, 4], [9, 8, 7], [5, 5, 5, 5, 5], [6, 7]]
# the second wave repeats two prompts -> prefix-reuse hits in the hash index
WAVE2 = [[1, 2, 3, 4], [9, 8, 7]]
MAX_NEW = 12


def config():
    return tiny_config("mistral-nemo-12b", d_model=128, n_layers=4)


def serve(eng):
    """Both waves through ``eng``; returns (engine steps, the requests in
    submission order)."""
    steps, reqs = 0, []
    for wave in (WAVE1, WAVE2):
        for p in wave:
            eng.submit(p, max_new=MAX_NEW)
            reqs.append(eng.queue[-1])
        steps += eng.run()
    return steps, reqs


def main(device=None):
    cfg = config()
    model = init_params(cfg, device=device)
    eng = ServingEngine(cfg, model, device=model.device, **ENGINE)
    steps, reqs = serve(eng)
    s = eng.stats
    print(f"served {len(reqs)} requests in {steps} engine steps "
          f"({s['decode_steps']} decode steps)")
    print(f"page directory: {s['pages_registered']} pages registered via "
          f"PUT, {s['pages_freed']} reclaimed via SCAN "
          f"({s['index_scans']} range scans)")
    print(f"prefix reuse: {s['prefix_hits']} hash-index hits on repeated "
          f"prompts ({s['index_gets']} GETs total)")
    assert s["prefix_hits"] >= 2
    print("serving example OK")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    main(ap.parse_args().device)
