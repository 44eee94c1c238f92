"""Official VOC-devkit result files + the `experiment.info` comp-id channel
(counterpart of ait_tpu/evaluation/voc_results.py).

The reference's eval CLI writes a one-line run tag to `experiment.info`
(test_net_voc.py:223-225, "Session-S_Epoch-E_Version-V"); the VOC imdb reads
it back as `_comp_id` (pascal_voc.py:75-80), optionally salts it with a uuid
(`:293-296`), and `_write_voc_results_file` (`:312-328`) emits per-class
files under `{devkit}/results/VOC{year}/Main/` named
`{comp_id}[_{salt}]_detection_{image_set}_{class}.txt`, one line per
detection: `index score x1+1 y1+1 x2+1 y2+1` (the devkit expects 1-based
coordinates).

The in-memory evaluator (`evaluation/voc_eval.py`) never needs these files;
this module exists so results can be fed to the original MATLAB/devkit
toolchain for independent verification and sharing.
"""

from __future__ import annotations

import os
import uuid
from typing import Dict, List, Sequence

import numpy as np

from ait_tpu_torch.data.records import ImageRecord


def comp_id_tag(session: int, epoch_or_step, version: str) -> str:
    """The reference's experiment.info payload (test_net_voc.py:223-225)."""
    return f"Session-{session}_Epoch-{epoch_or_step}_Version-{version}"


def write_experiment_info(tag: str, path: str = "experiment.info") -> str:
    with open(path, "w") as f:
        f.write(tag)
    return path


def read_experiment_info(path: str = "experiment.info") -> str:
    """pascal_voc.py:75-80 (first line becomes _comp_id)."""
    with open(path) as f:
        return f.readlines()[0].strip()


def _image_index(rec: ImageRecord) -> str:
    """Devkit image identifier: the annotation/image basename ('000005')."""
    return os.path.splitext(os.path.basename(rec.image_path))[0]


def write_voc_results_files(all_boxes: Dict[int, Dict[int, np.ndarray]],
                            records: Sequence[ImageRecord],
                            classes: Sequence[str],
                            devkit_path: str, year: str, image_set: str,
                            comp_id: str, use_salt: bool = True
                            ) -> List[str]:
    """Write per-class devkit result files; returns the file paths.

    all_boxes[class_ind][record_ind] = [N, 5] (x1,y1,x2,y2,score) 0-based
    original-image coords, exactly what the eval CLI accumulates.  Matches
    pascal_voc.py:312-328: skip background and empty images, +1 all coords.
    """
    if use_salt:  # pascal_voc.py:293-296
        comp_id = f"{comp_id}_{uuid.uuid4()}"
    filedir = os.path.join(devkit_path, "results", f"VOC{year}", "Main")
    os.makedirs(filedir, exist_ok=True)
    base = os.path.join(filedir, f"{comp_id}_detection_{image_set}")
    paths = []
    for cls_ind, class_name in enumerate(classes):
        if class_name == "__background__":
            continue
        if cls_ind not in all_boxes:
            continue
        filename = f"{base}_{class_name}.txt"
        with open(filename, "w") as f:
            for rec_ind in sorted(all_boxes[cls_ind]):
                dets = np.asarray(all_boxes[cls_ind][rec_ind])
                if dets.size == 0:
                    continue
                index = _image_index(records[rec_ind])
                for k in range(dets.shape[0]):
                    f.write(f"{index} {dets[k, -1]:.3f} "
                            f"{dets[k, 0] + 1:.1f} {dets[k, 1] + 1:.1f} "
                            f"{dets[k, 2] + 1:.1f} {dets[k, 3] + 1:.1f}\n")
        paths.append(filename)
    return paths
