"""A YOLOv5 detector from local TorchScript weights, for the crop pass.

Port of ``item_alignment_tpu/data/yolo.py``; it runs on CPU torch, as the
JAX package's does.  The reference's ``object_detection`` step loads YOLOv5
through ``torch.hub``, which downloads code and weights; here
``prepare --only_image --object_detection --yolo_weights`` runs a locally
exported YOLOv5 TorchScript file (the one export that loads without the
ultralytics sources).  The pre- and post-processing are YOLOv5's eval
pipeline: letterbox to ``imgsz`` with stride-32 padding (colour 114), / 255,
forward, decode the [N, 5+80] rows (xywh, objectness, class scores),
per-class NMS, and the boxes mapped back to the original image.  Rows are
``(x1, y1, x2, y2, class_name, confidence)``, the contract of
``data.images.crop_images_with_boxes(detector=...)``.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

# COCO-80 names in YOLOv5's class-index order (the names CATE2YOLO_CLASS
# whitelists, reference data_prepare.py:36-169)
COCO80_CLASSES = [
    "person", "bicycle", "car", "motorcycle", "airplane", "bus", "train",
    "truck", "boat", "traffic light", "fire hydrant", "stop sign",
    "parking meter", "bench", "bird", "cat", "dog", "horse", "sheep",
    "cow", "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella",
    "handbag", "tie", "suitcase", "frisbee", "skis", "snowboard",
    "sports ball", "kite", "baseball bat", "baseball glove", "skateboard",
    "surfboard", "tennis racket", "bottle", "wine glass", "cup", "fork",
    "knife", "spoon", "bowl", "banana", "apple", "sandwich", "orange",
    "broccoli", "carrot", "hot dog", "pizza", "donut", "cake", "chair",
    "couch", "potted plant", "bed", "dining table", "toilet", "tv",
    "laptop", "mouse", "remote", "keyboard", "cell phone", "microwave",
    "oven", "toaster", "sink", "refrigerator", "book", "clock", "vase",
    "scissors", "teddy bear", "hair drier", "toothbrush",
]


def letterbox(img: np.ndarray, new_size: int = 640, stride: int = 32,
              color: int = 114) -> Tuple[np.ndarray, float, Tuple[float, float]]:
    """YOLOv5 eval letterbox: scale the long side to ``new_size`` keeping
    aspect ratio (never upscale), pad symmetrically to a stride multiple.

    Returns (padded image, gain, (pad_w, pad_h)) — gain/pad undo the
    transform when mapping boxes back to original coordinates."""
    h, w = img.shape[:2]
    gain = min(new_size / h, new_size / w, 1.0)
    new_h, new_w = int(round(h * gain)), int(round(w * gain))
    if (new_h, new_w) != (h, w):
        from PIL import Image

        img = np.asarray(Image.fromarray(img).resize(
            (new_w, new_h), Image.BILINEAR))
    pad_h = (-new_h) % stride
    pad_w = (-new_w) % stride
    top, left = pad_h // 2, pad_w // 2
    out = np.full((new_h + pad_h, new_w + pad_w, 3), color, np.uint8)
    out[top:top + new_h, left:left + new_w] = img
    return out, gain, (float(left), float(top))


def nms(boxes: np.ndarray, scores: np.ndarray,
        iou_thres: float = 0.45) -> List[int]:
    """Greedy IoU NMS over xyxy ``boxes``; returns kept indices, highest
    score first."""
    order = np.argsort(-scores)
    keep: List[int] = []
    areas = np.maximum(boxes[:, 2] - boxes[:, 0], 0) * \
        np.maximum(boxes[:, 3] - boxes[:, 1], 0)
    while order.size:
        i = order[0]
        keep.append(int(i))
        if order.size == 1:
            break
        rest = order[1:]
        x1 = np.maximum(boxes[i, 0], boxes[rest, 0])
        y1 = np.maximum(boxes[i, 1], boxes[rest, 1])
        x2 = np.minimum(boxes[i, 2], boxes[rest, 2])
        y2 = np.minimum(boxes[i, 3], boxes[rest, 3])
        inter = np.maximum(x2 - x1, 0) * np.maximum(y2 - y1, 0)
        iou = inter / np.maximum(areas[i] + areas[rest] - inter, 1e-9)
        order = rest[iou <= iou_thres]
    return keep


def decode_predictions(pred: np.ndarray, conf_thres: float = 0.25,
                       iou_thres: float = 0.45,
                       class_names: Sequence[str] = COCO80_CLASSES,
                       max_det: int = 300) -> List[Tuple]:
    """YOLOv5 head output [N, 5+C] (xywh center-format, objectness, class
    scores) -> NMS'd ``(x1, y1, x2, y2, class_name, conf)`` rows in
    letterboxed-image coordinates.  Per-class NMS via the standard
    class-index * max_wh box offset trick."""
    pred = np.asarray(pred, np.float32)
    obj = pred[:, 4]
    cand = obj > conf_thres
    pred = pred[cand]
    if pred.size == 0:
        return []
    cls_scores = pred[:, 5:] * pred[:, 4:5]   # conf = obj * cls
    cls_idx = cls_scores.argmax(axis=1)
    conf = cls_scores[np.arange(len(pred)), cls_idx]
    m = conf > conf_thres
    if not m.any():
        return []
    pred, cls_idx, conf = pred[m], cls_idx[m], conf[m]
    cx, cy, w, h = pred[:, 0], pred[:, 1], pred[:, 2], pred[:, 3]
    boxes = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                     axis=1)
    offset = cls_idx.astype(np.float32)[:, None] * 7680.0
    keep = nms(boxes + offset, conf, iou_thres)[:max_det]
    return [(float(boxes[i, 0]), float(boxes[i, 1]), float(boxes[i, 2]),
             float(boxes[i, 3]), class_names[int(cls_idx[i])],
             float(conf[i])) for i in keep]


def scale_boxes(dets: List[Tuple], gain: float,
                pad: Tuple[float, float], orig_hw: Tuple[int, int]) -> List[Tuple]:
    """Map letterboxed-coordinate detections back to the original image."""
    h, w = orig_hw
    out = []
    for (x1, y1, x2, y2, name, conf) in dets:
        out.append((
            float(np.clip((x1 - pad[0]) / gain, 0, w)),
            float(np.clip((y1 - pad[1]) / gain, 0, h)),
            float(np.clip((x2 - pad[0]) / gain, 0, w)),
            float(np.clip((y2 - pad[1]) / gain, 0, h)),
            name, conf))
    return out


class YoloTorchscriptDetector:
    """Callable detector over a locally exported YOLOv5 TorchScript file.

    ``detector(img_hwc_rgb_uint8) -> [(x1, y1, x2, y2, class_name, conf)]``
    in original-image coordinates, for
    ``crop_images_with_boxes(detector=...)``.  Runs on CPU torch (a
    one-off offline pass)."""

    def __init__(self, weights_path: str, imgsz: int = 640,
                 conf_thres: float = 0.25, iou_thres: float = 0.45,
                 class_names: Sequence[str] = COCO80_CLASSES):
        import torch

        self._torch = torch
        self.model = torch.jit.load(weights_path, map_location="cpu")
        self.model.eval()
        self.imgsz = imgsz
        self.conf_thres = conf_thres
        self.iou_thres = iou_thres
        self.class_names = class_names

    def __call__(self, img: np.ndarray) -> List[Tuple]:
        torch = self._torch
        padded, gain, pad = letterbox(img, self.imgsz)
        x = torch.from_numpy(
            padded.transpose(2, 0, 1)[None].astype(np.float32) / 255.0)
        with torch.no_grad():
            y = self.model(x)
        # torchscript export returns (pred, ...) or pred; pred [1, N, 5+C]
        if isinstance(y, (tuple, list)):
            y = y[0]
        pred = y[0].cpu().numpy()
        dets = decode_predictions(pred, self.conf_thres, self.iou_thres,
                                  self.class_names)
        return scale_boxes(dets, gain, pad, img.shape[:2])
