"""Python API quickstart for the PyTorch port — the framework without the CLI.

Builds a dataset, a LightGCN model and a Trainer directly with
``textgcn_tpu_torch``; trains a few epochs, evaluates, and reads the
propagated representations off the device.  Counterpart of
``examples/api_quickstart.py``.

Run from the repo root on the card:
    python examples/torch_api_quickstart.py
Without a card:
    TEXTGCN_TPU_PLATFORM=cpu python examples/torch_api_quickstart.py
"""

import os
import sys
import tempfile

# allow running straight from a source checkout without installing
sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))
os.environ.setdefault('TEXTGCN_TPU_TEXT_ENCODER', 'stub')

import torch  # noqa: E402

from textgcn_tpu_torch import (Config, LightGCN, Trainer,  # noqa: E402
                               load_interactions)
from textgcn_tpu_torch.config import platform_device  # noqa: E402


def main(data_dir: str = 'data/dummy'):
    device = platform_device()      # the card, or TEXTGCN_TPU_PLATFORM=cpu
    cfg = Config(
        model='lgcn', data=data_dir,
        epochs=40, evaluate_every=20, batch_size=256,
        emb_size=32, n_layers=2, lr=5e-3, k=(3, 5), save=False,
        save_path=os.path.join(tempfile.gettempdir(), 'torch_api_quickstart'),
    ).finalize()

    data = load_interactions(cfg.data, seed=cfg.seed)
    print(f'{data.n_users} users x {data.n_items} items, '
          f'{data.graph.n_edges} edges, on {device}')

    model = LightGCN(cfg, data, device=device)
    trainer = Trainer(cfg, model, data)
    trainer.fit()

    # final metrics: dict metric -> [value@k for k in cfg.k]
    metrics = trainer.evaluate()
    for name, per_k in metrics.items():
        print(f'  {name}: ' + '  '.join(
            f'@{k}={v:.4f}' for k, v in zip(cfg.k, per_k)))

    # propagated (post-GCN) representations, e.g. for an external ANN index
    with torch.no_grad():
        users_emb, items_emb = model.representation()
    users_emb = users_emb[:data.n_users].cpu().numpy()
    items_emb = items_emb[:data.n_items].cpu().numpy()
    print('propagated tables:', users_emb.shape, items_emb.shape)

    # top-k retrieval for a few users (train items already masked out)
    preds, scores = trainer.predict(range(min(3, data.n_users)),
                                    with_scores=True)
    for u, (row, s) in enumerate(zip(preds, scores)):
        print(f'  user {u}: top items {row[:5]}  scores {s[:5]}')
    return metrics


if __name__ == '__main__':
    main(*sys.argv[1:])
