"""Serve recommendations from the PyTorch port's exported artifacts.

``--export_reprs`` writes plain ``.npy`` tensors so external systems (an
ANN index, a feature store, a different language runtime) can reproduce
the model's scores exactly:

* plain models: ``users_repr.npy`` / ``items_repr.npy`` with
  ``score = users_repr @ items_repr.T``
* LTR heads and the concat scorers: also ``ltr_user_factors.npy`` /
  ``ltr_item_factors.npy`` / ``ltr_bias.npy`` with
  ``score = u_cat @ i_cat.T + bias``.

This script writes a synthetic dataset with the port's generator, trains
a small ``lgcn`` through the port's CLI, exports, then serves the top-k
from the exported files with NOTHING but numpy — and checks the ranked
lists match the port's own ``predict``.  Counterpart of
``examples/serve_from_export.py``.

Run from the repo root on the card:
    python examples/torch_serve_from_export.py [WORK_DIR]
Without a card:
    TEXTGCN_TPU_PLATFORM=cpu python examples/torch_serve_from_export.py
WORK_DIR (default: a new temporary directory) receives the dataset and
``runs/``.
"""

import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))
os.environ.setdefault('TEXTGCN_TPU_TEXT_ENCODER', 'stub')

import numpy as np  # noqa: E402


def serve_topk_numpy(run_dir, user_ids, k, train_positives):
    """Pure-numpy retrieval from the exported artifacts."""
    u = np.load(os.path.join(run_dir, 'users_repr.npy'))
    i = np.load(os.path.join(run_dir, 'items_repr.npy'))
    scores = u[user_ids] @ i.T                      # (B, n_items)
    for row, uid in enumerate(user_ids):            # mask seen items
        scores[row, train_positives[uid]] = -np.inf
    # stable: ties break by the lower index
    top = np.argsort(-scores, axis=1, kind='stable')[:, :k]
    return top, np.take_along_axis(scores, top, axis=1)


def main(work_dir: str | None = None):
    from textgcn_tpu_torch.cli import main as cli_main
    from textgcn_tpu_torch.tools.make_synthetic import generate

    work_dir = os.path.abspath(work_dir or tempfile.mkdtemp(
        prefix='torch_serve_'))
    data_dir = os.path.join(work_dir, 'serve_data')
    if not os.path.exists(os.path.join(data_dir, 'train.tsv')):
        generate(data_dir, n_users=800, n_items=400, seed=0)

    cwd = os.getcwd()
    os.chdir(work_dir)              # runs/ goes under the work directory
    try:
        trainer = cli_main([
            '--model', 'lgcn', '--data', data_dir, '--epochs', '30',
            '--evaluate_every', '15', '--lr', '5e-3', '--uid', 'serve_demo',
            '--export_reprs'])
    finally:
        os.chdir(cwd)
    run_dir = os.path.join(work_dir, trainer.cfg.save_path)

    data = trainer.data
    users = list(range(5))
    k = 10
    train_pos = {u: data.pos_padded[u][:data.pos_degree[u]].tolist()
                 for u in users}
    top, scores = serve_topk_numpy(run_dir, users, k, train_pos)

    # the port's own retrieval must agree
    preds, _ = trainer.predict(users, with_scores=True)
    for row, uid in enumerate(users):
        assert top[row].tolist() == list(preds[row][:k]), \
            f'user {uid}: exported-artifact serving diverged'
    print(f'numpy serving from {run_dir} matches the port\'s predict() '
          f'for {len(users)} users @ k={k}')
    print('top items for user 0:', top[0].tolist())
    return top


if __name__ == '__main__':
    main(*sys.argv[1:])
