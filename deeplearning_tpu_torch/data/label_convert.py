"""Annotation format converters: VOC ↔ COCO ↔ YOLO — a copy of
``deeplearning_tpu/data/label_convert.py`` (numpy and the standard library
only; the port keeps its own copy).

Surface of others/label_convert (voc2coco.py, coco2voc.py, yolo2coco.py,
coco2yolo.py, voc2yolo.py, yolo2voc.py + show_img_by_* viewers). Formats:

- VOC:  per-image XML with absolute xyxy boxes + class names.
- COCO: one JSON with images/annotations/categories, boxes xywh absolute.
- YOLO: per-image .txt rows ``cls cx cy w h`` normalized to [0, 1].

Converters operate on in-memory dicts (parse/serialize helpers included),
so they also serve as the dataset-loading path for detection training.
"""

from __future__ import annotations

import json
import os
import xml.etree.ElementTree as ET
from typing import Dict, List, Sequence, Tuple

import numpy as np


# ------------------------------------------------------------- VOC (XML)
def parse_voc_xml(path: str) -> Dict:
    root = ET.parse(path).getroot()
    size = root.find("size")
    rec = {
        "filename": root.findtext("filename", ""),
        "width": int(size.findtext("width")),
        "height": int(size.findtext("height")),
        "boxes": [], "names": [], "difficult": [],
    }
    for obj in root.findall("object"):
        bb = obj.find("bndbox")
        rec["boxes"].append([float(bb.findtext(k)) for k in
                             ("xmin", "ymin", "xmax", "ymax")])
        rec["names"].append(obj.findtext("name"))
        rec["difficult"].append(int(obj.findtext("difficult", "0")))
    rec["boxes"] = np.asarray(rec["boxes"], np.float32).reshape(-1, 4)
    rec["difficult"] = np.asarray(rec["difficult"], bool)
    return rec


def write_voc_xml(rec: Dict, path: str) -> None:
    root = ET.Element("annotation")
    ET.SubElement(root, "filename").text = rec.get("filename", "")
    size = ET.SubElement(root, "size")
    ET.SubElement(size, "width").text = str(rec["width"])
    ET.SubElement(size, "height").text = str(rec["height"])
    ET.SubElement(size, "depth").text = "3"
    difficult = rec.get("difficult")
    if difficult is None:
        difficult = np.zeros(len(rec["boxes"]), bool)
    for box, name, diff in zip(rec["boxes"], rec["names"], difficult):
        obj = ET.SubElement(root, "object")
        ET.SubElement(obj, "name").text = str(name)
        ET.SubElement(obj, "difficult").text = str(int(diff))
        bb = ET.SubElement(obj, "bndbox")
        for k, v in zip(("xmin", "ymin", "xmax", "ymax"), box):
            ET.SubElement(bb, k).text = str(float(v))
    ET.ElementTree(root).write(path)


# ------------------------------------------------------------ COCO (JSON)
def records_to_coco(records: Sequence[Dict], class_names: Sequence[str]
                    ) -> Dict:
    name_to_id = {n: i + 1 for i, n in enumerate(class_names)}  # 1-based
    coco = {"images": [], "annotations": [],
            "categories": [{"id": i + 1, "name": n}
                           for i, n in enumerate(class_names)]}
    ann_id = 1
    for img_id, rec in enumerate(records, start=1):
        coco["images"].append({
            "id": img_id, "file_name": rec.get("filename", f"{img_id}.jpg"),
            "width": rec["width"], "height": rec["height"]})
        for box, name in zip(rec["boxes"], rec["names"]):
            x1, y1, x2, y2 = (float(v) for v in box)
            coco["annotations"].append({
                "id": ann_id, "image_id": img_id,
                "category_id": name_to_id[name],
                "bbox": [x1, y1, x2 - x1, y2 - y1],
                "area": (x2 - x1) * (y2 - y1), "iscrowd": 0})
            ann_id += 1
    return coco


def coco_to_records(coco: Dict) -> List[Dict]:
    cats = {c["id"]: c["name"] for c in coco["categories"]}
    by_img = {img["id"]: {"filename": img.get("file_name", ""),
                          "width": img["width"], "height": img["height"],
                          "boxes": [], "names": [], "difficult": []}
              for img in coco["images"]}
    for ann in coco["annotations"]:
        rec = by_img[ann["image_id"]]
        x, y, w, h = ann["bbox"]
        rec["boxes"].append([x, y, x + w, y + h])
        rec["names"].append(cats[ann["category_id"]])
        rec["difficult"].append(bool(ann.get("iscrowd", 0)))
    out = []
    for img in coco["images"]:              # preserve image order
        rec = by_img[img["id"]]
        rec["boxes"] = np.asarray(rec["boxes"], np.float32).reshape(-1, 4)
        rec["difficult"] = np.asarray(rec["difficult"], bool)
        out.append(rec)
    return out


# ------------------------------------------------------------ YOLO (txt)
def record_to_yolo(rec: Dict, class_names: Sequence[str]) -> str:
    """One image's boxes → 'cls cx cy w h' normalized lines."""
    name_to_id = {n: i for i, n in enumerate(class_names)}   # 0-based
    lines = []
    w, h = rec["width"], rec["height"]
    for box, name in zip(rec["boxes"], rec["names"]):
        x1, y1, x2, y2 = (float(v) for v in box)
        lines.append(f"{name_to_id[name]} {(x1 + x2) / 2 / w:.6f} "
                     f"{(y1 + y2) / 2 / h:.6f} {(x2 - x1) / w:.6f} "
                     f"{(y2 - y1) / h:.6f}")
    return "\n".join(lines)


def yolo_to_record(text: str, width: int, height: int,
                   class_names: Sequence[str]) -> Dict:
    boxes, names = [], []
    for line in text.strip().splitlines():
        if not line.strip():
            continue
        cls, cx, cy, w, h = line.split()
        cx, cy, w, h = (float(v) for v in (cx, cy, w, h))
        boxes.append([(cx - w / 2) * width, (cy - h / 2) * height,
                      (cx + w / 2) * width, (cy + h / 2) * height])
        names.append(class_names[int(cls)])
    return {"width": width, "height": height,
            "boxes": np.asarray(boxes, np.float32).reshape(-1, 4),
            "names": names,
            "difficult": np.zeros(len(names), bool)}


def records_to_arrays(records: Sequence[Dict], class_names: Sequence[str],
                      max_boxes: int = 64) -> Dict[str, np.ndarray]:
    """Padded fixed-shape training arrays {boxes, labels, valid} — the
    bridge from any annotation format to the jitted detectors."""
    name_to_id = {n: i for i, n in enumerate(class_names)}
    n = len(records)
    boxes = np.zeros((n, max_boxes, 4), np.float32)
    labels = np.zeros((n, max_boxes), np.int64)
    valid = np.zeros((n, max_boxes), bool)
    for i, rec in enumerate(records):
        take = min(len(rec["boxes"]), max_boxes)
        boxes[i, :take] = rec["boxes"][:take]
        labels[i, :take] = [name_to_id[x] for x in rec["names"][:take]]
        valid[i, :take] = True
    return {"boxes": boxes, "labels": labels, "valid": valid}
