"""Retrieval serving entry point (counterpart of ``editor_tpu/cli/serve.py``).

    # index the dataset's gallery split, then serve queries over HTTP
    python -m editor_tpu_torch.cli.serve --config_file configs/RGBNT201.yaml \\
        --port 8080 TEST.WEIGHT path/to/OUTPUT_DIR/ckpt

    # or serve a saved index
    python -m editor_tpu_torch.cli.serve --config_file configs/RGBNT201.yaml \\
        --index gallery.npz --port 8080 TEST.WEIGHT path/to/EDITOR.pth

Query with:
    curl -s localhost:8080/query -d '{"images": {"RGB": "<b64 jpeg>",
        "NI": "...", "TI": "..."}, "topk": 5}'

``TEST.WEIGHT``: a checkpoint directory of the port's training loop, a
``.pth`` state_dict in the reference layout, or empty (seeded random
weights), as ``cli.test``. ``--device cpu`` serves from the CPU; by default
the current CUDA device.
"""

from __future__ import annotations

import argparse


def build_service(cfg, weight: str = "", index_path: str = "", batch_size: int = 32,
                  save_index: str = "", device=None, splits=None, decode_fn=None):
    """Load the weights and index the gallery split (the val items after
    ``num_query``; or load ``index_path``): returns (FeatureExtractor,
    GalleryIndex). ``splits`` and ``decode_fn`` as in ``cli.train.main``."""
    import numpy as np
    import torch

    from editor_tpu_torch.data.loader import ReIDDataModule
    from editor_tpu_torch.models.editor import editor_config_from
    from editor_tpu_torch.models.init import editor_init
    from editor_tpu_torch.serve import FeatureExtractor, GalleryIndex

    dm = ReIDDataModule(cfg, splits=splits, decode_fn=decode_fn)
    ecfg = editor_config_from(cfg, dm.num_classes, dm.cam_num)
    model = editor_init(ecfg, seed=cfg.SOLVER.SEED, device=device)
    if weight.endswith(".pth"):
        from editor_tpu_torch.utils.torch_convert import load_editor_pth
        load_editor_pth(weight, model)
    elif weight:
        from editor_tpu_torch.utils.checkpoint import restore_eval_state
        model.load_state_dict(restore_eval_state(weight), strict=True)

    extractor = FeatureExtractor(model, batch_size=batch_size,
                                 compute_dtype=getattr(torch, cfg.TPU.COMPUTE_DTYPE),
                                 input_cfg=cfg.INPUT)
    if index_path:
        index = GalleryIndex.load(index_path)
        if index.feat_dim != extractor.feat_dim:
            raise ValueError(f"index dim {index.feat_dim} != model {extractor.feat_dim}")
        return extractor, index

    index = GalleryIndex(extractor.feat_dim, feat_norm=cfg.TEST.FEAT_NORM == "yes")
    # gallery = the val items after the query block (reference metrics split,
    # utils/metrics.py:263-274)
    nq, total, seen = dm.num_query, len(dm.val_items), 0
    for batch in dm.val_batches():
        take = min(len(batch["pid"]), total - seen)
        idxs = np.arange(seen, seen + take)
        keep = idxs >= nq
        if keep.any():
            feats = extractor({m: batch[m][:take][keep] for m in ("RGB", "NI", "TI")
                               if m in batch}, batch["camid"][:take][keep])
            index.add(feats, batch["pid"][:take][keep], batch["camid"][:take][keep],
                      [str(dm.val_items[i][0]) for i in idxs[keep]])
        seen += take
    if save_index:
        index.save(save_index)
    return extractor, index


def main(argv=None, splits=None, decode_fn=None):
    """Parse ``argv``, build the service and serve until interrupted."""
    parser = argparse.ArgumentParser(description="editor_tpu_torch retrieval server")
    parser.add_argument("--config_file", default="", type=str)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", default=8080, type=int)
    parser.add_argument("--batch_size", default=32, type=int,
                        help="extraction batch (short requests pad to a power of two)")
    parser.add_argument("--index", default="", type=str,
                        help="load a saved gallery .npz instead of indexing")
    parser.add_argument("--save_index", default="", type=str,
                        help="save the built gallery index to this .npz")
    parser.add_argument("--device", default=None, help="e.g. 'cpu'; default: current CUDA device")
    parser.add_argument("opts", nargs=argparse.REMAINDER, help="KEY VALUE config overrides")
    args = parser.parse_args(argv)

    from editor_tpu_torch.config import load_config
    from editor_tpu_torch.serve import RetrievalServer
    from editor_tpu_torch.utils.logger import setup_logger

    cfg = load_config(args.config_file or None, args.opts or None)
    logger = setup_logger("editor_tpu_torch.serve", cfg.OUTPUT_DIR, "serve_log.txt")
    extractor, index = build_service(cfg, cfg.TEST.WEIGHT, args.index, args.batch_size,
                                     args.save_index, device=args.device, splits=splits,
                                     decode_fn=decode_fn)
    server = RetrievalServer(extractor, index, args.host, args.port)
    logger.info("serving %d gallery entries (dim %d) on %s:%d", len(index), index.feat_dim,
                *server.address)
    server.serve_forever()


if __name__ == "__main__":
    main()
