"""Dataset adapters: parse on-disk layouts into (paths, pid, camid, extra) lists.

The port's copy of ``editor_tpu/data/datasets.py`` (reference:
data/datasets/{RGBNT201,RGBNT100,msvr310,market_to_RGBNT201}.py and
bases.py), pure Python: the item lists come out identical. Each adapter scans
the filesystem once; everything downstream is index-based.

Item tuples: (img_paths, pid, camid, trackid_or_sceneid) where img_paths is a
list of per-modality paths (RGB, NI, TI) or a single wide-JPEG path whose
horizontal 256-px tiles are the modalities (RGBNT100/300, bases.py:21-26).
"""

from __future__ import annotations

import glob
import os
import os.path as osp
import re
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

Item = Tuple[object, int, int, int]


@dataclass
class DatasetSplits:
    train: List[Item]
    query: List[Item]
    gallery: List[Item]
    num_train_pids: int
    num_train_cams: int
    num_modalities: int = 3
    wide_jpeg: bool = False  # modalities tiled side-by-side in one image
    has_sceneid: bool = False  # MSVR310 eval protocol

    @property
    def num_query(self) -> int:
        return len(self.query)


def _stats(items: Sequence[Item]) -> Tuple[int, int]:
    pids = {it[1] for it in items}
    cams = {it[2] for it in items}
    return len(pids), len(cams)


def print_dataset_statistics(name: str, ds: DatasetSplits) -> str:
    """Summary table (reference BaseImageDataset.print_dataset_statistics,
    bases.py:69-86)."""
    lines = [f"Dataset statistics: {name}"]
    for split, items in (("train", ds.train), ("query", ds.query),
                         ("gallery", ds.gallery)):
        np_, nc = _stats(items)
        lines.append(f"  {split:8s} | {np_:5d} ids | {len(items):8d} images | "
                     f"{nc:3d} cameras")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# RGBNT201 — per-modality subdirs, pid/camid from filename
# (reference: data/datasets/RGBNT201.py:63-89)
# ---------------------------------------------------------------------------

def _scan_rgbnt201_dir(dir_path: str, relabel: bool) -> List[Item]:
    rgb_paths = sorted(glob.glob(osp.join(dir_path, "RGB", "*.jpg")))
    pids = sorted({int(osp.basename(p).split("_")[0][:6]) for p in rgb_paths})
    pid2label = {pid: i for i, pid in enumerate(pids)}
    items: List[Item] = []
    for rgb in rgb_paths:
        name = osp.basename(rgb)
        pid = int(name.split("_")[0][:6])
        camid = int(name.split("_")[1][3]) - 1
        paths = [rgb, osp.join(dir_path, "NI", name), osp.join(dir_path, "TI", name)]
        items.append((paths, pid2label[pid] if relabel else pid, camid, -1))
    return items


def load_rgbnt201(root: str) -> DatasetSplits:
    base = osp.join(root, "RGBNT201")
    train = _scan_rgbnt201_dir(osp.join(base, "train_171"), relabel=True)
    query = _scan_rgbnt201_dir(osp.join(base, "test"), relabel=False)
    gallery = list(query)  # reference uses test dir for both query & gallery
    np_, nc = _stats(train)
    return DatasetSplits(train, query, gallery, np_, nc)


# ---------------------------------------------------------------------------
# RGBNT100 / RGBN300 — single wide JPEG, regex ids
# (reference: data/datasets/RGBNT100.py:64-89)
# ---------------------------------------------------------------------------

_WIDE_RE = re.compile(r"([-\d]+)_c([-\d]+)")


def _scan_wide_dir(dir_path: str, relabel: bool) -> List[Item]:
    paths = sorted(glob.glob(osp.join(dir_path, "*.jpg")))
    pids = sorted({int(_WIDE_RE.search(p).group(1)) for p in paths
                   if int(_WIDE_RE.search(p).group(1)) != -1})
    pid2label = {pid: i for i, pid in enumerate(pids)}
    items: List[Item] = []
    for p in paths:
        pid, camid = map(int, _WIDE_RE.search(p).groups())
        if pid == -1:
            continue
        items.append((p, pid2label[pid] if relabel else pid, camid - 1, -1))
    return items


def load_rgbnt100(root: str) -> DatasetSplits:
    base = osp.join(root, "RGBNT100", "rgbir")
    train = _scan_wide_dir(osp.join(base, "bounding_box_train"), relabel=True)
    query = _scan_wide_dir(osp.join(base, "query"), relabel=False)
    gallery = _scan_wide_dir(osp.join(base, "bounding_box_test"), relabel=False)
    np_, nc = _stats(train)
    return DatasetSplits(train, query, gallery, np_, nc, wide_jpeg=True)


def load_rgbn300(root: str) -> DatasetSplits:
    base = osp.join(root, "RGBN300", "rgbir")
    train = _scan_wide_dir(osp.join(base, "bounding_box_train"), relabel=True)
    query = _scan_wide_dir(osp.join(base, "query"), relabel=False)
    gallery = _scan_wide_dir(osp.join(base, "bounding_box_test"), relabel=False)
    np_, nc = _stats(train)
    return DatasetSplits(train, query, gallery, np_, nc, num_modalities=2,
                         wide_jpeg=True)


# ---------------------------------------------------------------------------
# MSVR310 — per-vehicle dirs with vis/ni/th subdirs + scene id
# (reference: data/datasets/msvr310.py:67-88)
# ---------------------------------------------------------------------------

def _scan_msvr_dir(dir_path: str, relabel: bool) -> List[Item]:
    vids = sorted(os.listdir(dir_path))
    vid2label = {int(v): i for i, v in enumerate(sorted({int(v) for v in vids}))}
    items: List[Item] = []
    for vid in vids:
        vis_dir = osp.join(dir_path, vid, "vis")
        for img in sorted(os.listdir(vis_dir)):
            paths = [osp.join(dir_path, vid, m, img) for m in ("vis", "ni", "th")]
            pid = int(img[0:4])
            sceneid = int(img[6:9])
            camid = int(img[11])
            items.append((paths, vid2label[pid] if relabel else pid, camid,
                          sceneid))
    return items


def load_msvr310(root: str) -> DatasetSplits:
    base = osp.join(root, "MSVR310")
    train = _scan_msvr_dir(osp.join(base, "train"), relabel=True)
    query = _scan_msvr_dir(osp.join(base, "query3"), relabel=False)
    gallery = _scan_msvr_dir(osp.join(base, "bounding_box_test"), relabel=False)
    np_, nc = _stats(train)
    return DatasetSplits(train, query, gallery, np_, nc, has_sceneid=True)


# ---------------------------------------------------------------------------
# Market1501-MM — synthetic RGB/NI/TI triplets from Market1501
# (reference: data/datasets/market_to_RGBNT201.py:63-95)
# ---------------------------------------------------------------------------

def _scan_market_mm_dir(dir_path: str, relabel: bool) -> List[Item]:
    rgb_paths = sorted(glob.glob(osp.join(dir_path, "RGB", "*.jpg")))
    pids = sorted({int(osp.basename(p).split("_")[0]) for p in rgb_paths
                   if int(osp.basename(p).split("_")[0]) != -1})
    pid2label = {pid: i for i, pid in enumerate(pids)}
    items: List[Item] = []
    for rgb in rgb_paths:
        name = osp.basename(rgb)
        pid = int(name.split("_")[0])
        if pid == -1:
            continue
        camid = int(name.split("_")[1][1]) - 1
        paths = [rgb, osp.join(dir_path, "NI", name), osp.join(dir_path, "TI", name)]
        items.append((paths, pid2label[pid] if relabel else pid, camid, -1))
    return items


def load_market1501_mm(root: str) -> DatasetSplits:
    base = osp.join(root, "Market1501-MM")
    train = _scan_market_mm_dir(osp.join(base, "bounding_box_train"), relabel=True)
    query = _scan_market_mm_dir(osp.join(base, "query"), relabel=False)
    gallery = _scan_market_mm_dir(osp.join(base, "bounding_box_test"),
                                  relabel=False)
    np_, nc = _stats(train)
    return DatasetSplits(train, query, gallery, np_, nc)


# ---------------------------------------------------------------------------
# single-modal person-ReID adapters (reference factory rows,
# data/datasets/make_dataloader.py:20-29: market1501 / dukemtmc / msmt17)
# ---------------------------------------------------------------------------

_PID_CAM_RE = re.compile(r"([-\d]+)_c(\d+)")


def _scan_single_modal_dir(dir_path: str, relabel: bool,
                           max_pid: Optional[int] = None) -> List[Item]:
    """market1501/dukemtmcreid layout: flat '*.jpg' named '<pid>_c<cam>…'
    (reference market1501.py:64-85, dukemtmcreid.py:88-110); pid==-1 junk
    images are skipped."""
    img_paths = sorted(glob.glob(osp.join(dir_path, "*.jpg")))
    pids = set()
    for p in img_paths:
        pid = int(_PID_CAM_RE.search(osp.basename(p)).group(1))
        if pid != -1:
            pids.add(pid)
    pid2label = {pid: i for i, pid in enumerate(sorted(pids))}
    items: List[Item] = []
    for p in img_paths:
        m = _PID_CAM_RE.search(osp.basename(p))
        pid, camid = int(m.group(1)), int(m.group(2))
        if pid == -1:
            continue
        if max_pid is not None:
            assert 0 <= pid <= max_pid, (p, pid)
        items.append(([p], pid2label[pid] if relabel else pid, camid - 1, 1))
    return items


def _load_single_modal(base: str) -> DatasetSplits:
    train = _scan_single_modal_dir(osp.join(base, "bounding_box_train"),
                                   relabel=True)
    query = _scan_single_modal_dir(osp.join(base, "query"), relabel=False)
    gallery = _scan_single_modal_dir(osp.join(base, "bounding_box_test"),
                                     relabel=False)
    np_, nc = _stats(train)
    return DatasetSplits(train, query, gallery, np_, nc, num_modalities=1)


def load_market1501(root: str) -> DatasetSplits:
    return _load_single_modal(osp.join(root, "market1501"))


def load_dukemtmcreid(root: str) -> DatasetSplits:
    return _load_single_modal(
        osp.join(root, "dukemtmc-reid", "DukeMTMC-reID"))


def load_msmt17(root: str) -> DatasetSplits:
    """MSMT17 V2: list files name images + pids; camid parsed from the
    filename's third '_' field (reference msmt17.py:63-78); train and val
    lists are concatenated into the train split (msmt17.py:38-40)."""
    base = osp.join(root, "MSMT17")
    train_dir = osp.join(base, "mask_train_v2")
    test_dir = osp.join(base, "mask_test_v2")

    def process(dir_path: str, list_path: str) -> List[Item]:
        items: List[Item] = []
        with open(list_path) as fh:
            for line in fh:
                rel, pid = line.split(" ")
                camid = int(rel.split("_")[2])
                items.append(([osp.join(dir_path, rel)], int(pid),
                              camid - 1, 1))
        return items

    train = process(train_dir, osp.join(base, "list_train.txt"))
    train += process(train_dir, osp.join(base, "list_val.txt"))
    query = process(test_dir, osp.join(base, "list_query.txt"))
    gallery = process(test_dir, osp.join(base, "list_gallery.txt"))
    np_, nc = _stats(train)
    return DatasetSplits(train, query, gallery, np_, nc, num_modalities=1)


DATASET_FACTORY = {
    # reference factory dict (make_dataloader.py:20-29)
    "RGBNT201": load_rgbnt201,
    "RGBNT100": load_rgbnt100,
    "RGBN300": load_rgbn300,
    "MSVR310": load_msvr310,
    "Market1501-MM": load_market1501_mm,
    "Market1501_MM": load_market1501_mm,
    "market1501": load_market1501,
    "dukemtmcreid": load_dukemtmcreid,
    "msmt17": load_msmt17,
}


def load_dataset(name: str, root: str) -> DatasetSplits:
    if name not in DATASET_FACTORY:
        raise KeyError(f"unknown dataset '{name}'; have {sorted(DATASET_FACTORY)}")
    return DATASET_FACTORY[name](root)
