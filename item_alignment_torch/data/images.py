"""The image data: transforms, shards, the embedding dump and the crops.

Port of ``item_alignment_tpu/data/images.py``.  The host code is numpy and
PIL, call for call as in the JAX package, so its outputs are equal bit for
bit:

- ``load_image`` (uint8 HWC RGB, or None for an image that does not
  decode; a missing Pillow raises ``ImportError``, where the JAX package
  counts every image as broken), ``center_crop``, ``normalize``,
  ``eval_transform`` (PIL bicubic resize of the shorter side to
  ``size / crop_pct``, centre crop) and ``train_transform`` (random resized
  crop and horizontal flip from a ``np.random.RandomState``), with
  ``normalized=False`` giving the post-crop uint8 image the shards store;
- ``device_resize_normalize``: uint8 NHWC -> normalised NHWC on the
  tensor's device, bilinear with antialiasing as ``jax.image.resize``
  shrinks;
- ``dump_image_embeddings`` (``image_embedding.json`` through an image
  tower), ``write_image_shards`` / ``read_image_shards`` (``.npz`` shards of
  image pairs);
- the detection-guided crop: ``CATE2YOLO_CLASS``, ``yolo_box_crop``,
  ``propose_box_saliency``, ``crop_images_with_boxes`` (JPEG quality 95)
  and ``crop_largest_detection``;
- the embedding text: ``embedding_texts``, ``embedding_texts_from_mapping``
  and ``write_embedding_json``.  Each vector is a row of comma-joined
  ``%.9g`` decimals, which give every fp32 value back exactly, and NaN,
  +inf and -inf as ``json.dump`` spells them (``NaN``, ``Infinity``,
  ``-Infinity``), so the JSON written is JSON.  The rows come from the
  native formatter (``data/native_loader.format_rows``), as in the JAX
  package.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from item_alignment_torch.utils import logger

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def load_image(path: str) -> Optional[np.ndarray]:
    """uint8 HWC RGB, or None for an image that does not decode (the
    reference drops broken images).  Without Pillow this raises."""
    from PIL import Image

    try:
        with Image.open(path) as im:
            return np.asarray(im.convert("RGB"))
    except (OSError, ValueError, SyntaxError, Image.DecompressionBombError):
        return None


def _resize(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.fromarray(img).resize(
        (size[1], size[0]), Image.BICUBIC))


def center_crop(img: np.ndarray, size: int) -> np.ndarray:
    h, w = img.shape[:2]
    top = max((h - size) // 2, 0)
    left = max((w - size) // 2, 0)
    return img[top:top + size, left:left + size]


def normalize(img: np.ndarray) -> np.ndarray:
    x = img.astype(np.float32) / 255.0
    return (x - IMAGENET_MEAN) / IMAGENET_STD


def eval_transform(img: np.ndarray, image_size: int,
                   crop_pct: float = 0.875,
                   normalized: bool = True) -> np.ndarray:
    """Resize the shorter side to ``image_size / crop_pct``, then centre
    crop (timm's eval transform).  ``normalized=False`` returns the
    post-crop uint8 image (the shards' form; the towers normalise uint8 on
    the device)."""
    scale_size = int(round(image_size / crop_pct))
    h, w = img.shape[:2]
    if h < w:
        new_h, new_w = scale_size, int(round(w * scale_size / h))
    else:
        new_h, new_w = int(round(h * scale_size / w)), scale_size
    img = _resize(img, (new_h, new_w))
    img = center_crop(img, image_size)
    return normalize(img) if normalized else np.ascontiguousarray(img)


def train_transform(img: np.ndarray, image_size: int,
                    rng: Optional[np.random.RandomState] = None,
                    hflip: float = 0.5,
                    scale: Tuple[float, float] = (0.08, 1.0),
                    ratio: Tuple[float, float] = (3 / 4, 4 / 3),
                    normalized: bool = True) -> np.ndarray:
    """Random resized crop, horizontal flip and normalisation (timm's
    train transform without colour jitter).  ``normalized=False`` returns
    post-crop uint8."""
    rng = rng or np.random.RandomState()
    h, w = img.shape[:2]
    area = h * w
    for _ in range(10):
        target_area = rng.uniform(*scale) * area
        aspect = np.exp(rng.uniform(np.log(ratio[0]), np.log(ratio[1])))
        cw = int(round(np.sqrt(target_area * aspect)))
        ch = int(round(np.sqrt(target_area / aspect)))
        if cw <= w and ch <= h:
            top = rng.randint(0, h - ch + 1)
            left = rng.randint(0, w - cw + 1)
            img_c = img[top:top + ch, left:left + cw]
            break
    else:
        img_c = center_crop(img, min(h, w))
    img_c = _resize(img_c, (image_size, image_size))
    if rng.rand() < hflip:
        img_c = img_c[:, ::-1]
    img_c = np.ascontiguousarray(img_c)
    return normalize(img_c) if normalized else img_c


def device_resize_normalize(images_u8: torch.Tensor, image_size: int
                            ) -> torch.Tensor:
    """uint8 [B, H, W, 3] -> normalised fp32 [B, S, S, 3] on the images'
    device: ``/ 255``, bilinear resize with antialiasing (a triangle filter
    as wide as the scale when shrinking, as ``jax.image.resize`` does),
    then ``(x - mean) / std``."""
    x = images_u8.float().permute(0, 3, 1, 2) / torch.tensor(
        255.0, device=images_u8.device)
    x = F.interpolate(x, size=(image_size, image_size), mode="bilinear",
                      align_corners=False, antialias=True)
    mean = torch.as_tensor(IMAGENET_MEAN, device=x.device)
    std = torch.as_tensor(IMAGENET_STD, device=x.device)
    return (x.permute(0, 2, 3, 1) - mean) / std


# ---------------------------------------------------------- offline dumps
def embedding_texts(mat: np.ndarray) -> List[str]:
    """[n, d] floats -> comma-joined ``%.9g`` rows of their fp32 values, one
    per vector, through the native formatter."""
    from item_alignment_torch.data.native_loader import format_rows

    return format_rows(mat)


def embedding_texts_from_mapping(raw: Dict[str, Sequence[float]]
                                 ) -> Dict[str, str]:
    """{id: floats} (a ``json.load``'ed ``image_embedding.json``) -> {id:
    text}, each vector rounded to fp32 first; rows of any length."""
    items = list(raw.items())
    if not items:
        return {}
    try:
        mat = np.asarray([v for _, v in items], np.float32)
        if mat.ndim != 2:
            raise ValueError("ragged")
        texts = embedding_texts(mat)
    except ValueError:  # ragged rows: one row at a time
        texts = [embedding_texts(np.asarray([v], np.float32))[0]
                 for _, v in items]
    return {k: t for (k, _), t in zip(items, texts)}


def load_embedding_json(path: str) -> Dict[str, str]:
    """``image_embedding.json`` -> {item id: embedding text}."""
    with open(path, encoding="utf-8") as r:
        return embedding_texts_from_mapping(json.load(r))


def write_embedding_json(ids: Sequence[str], texts: Sequence[str],
                         out_path: str) -> None:
    """``image_embedding.json``, ``{item_id: [floats...]}``, from row texts
    (``ensure_ascii=False`` keeps UTF-8 ids literal)."""
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w", encoding="utf-8") as w:
        w.write("{")
        for i, (iid, text) in enumerate(zip(ids, texts)):
            if i:
                w.write(",")
            w.write(f"{json.dumps(iid, ensure_ascii=False)}: [{text}]")
        w.write("}")


def dump_image_embeddings(item_ids: Sequence[str],
                          image_paths: Sequence[str],
                          encode_fn: Callable[[np.ndarray], np.ndarray],
                          out_path: str, image_size: int = 288,
                          batch_size: int = 32,
                          missing_dim: Optional[int] = None
                          ) -> Dict[str, str]:
    """Run an image tower (``encode_fn``: normalised [B, S, S, 3] fp32 ->
    [B, d]) over every item's image in batches of ``batch_size`` and write
    ``image_embedding.json`` {item_id: embedding}.  Returns {item_id:
    embedding text}, the form the TSV writer and the JSON take.  With
    ``missing_dim``, an image that does not load gets a zero vector of that
    width (the reference's ``img_emb_missing``), after the others; without
    it, such an item is left out."""
    total = len(item_ids)
    ids: List[str] = []
    mats: List[np.ndarray] = []
    missing_ids: List[str] = []
    batch_imgs, batch_ids = [], []

    def flush():
        if not batch_imgs:
            return
        mats.append(np.asarray(encode_fn(np.stack(batch_imgs)), np.float32))
        ids.extend(batch_ids)
        batch_imgs.clear()
        batch_ids.clear()
        if len(ids) % (batch_size * 64) < batch_size:
            logger.info("image embeddings: %d/%d encoded", len(ids), total)

    for iid, path in zip(item_ids, image_paths):
        img = load_image(path)
        if img is None:
            if missing_dim:
                missing_ids.append(iid)
            continue
        batch_imgs.append(eval_transform(img, image_size))
        batch_ids.append(iid)
        if len(batch_imgs) == batch_size:
            flush()
    flush()
    mat = (np.concatenate(mats, axis=0) if mats
           else np.zeros((0, missing_dim or 0), np.float32))
    if missing_ids:
        dim = mat.shape[1] if mat.size else missing_dim
        mat = np.concatenate(
            [mat, np.zeros((len(missing_ids), dim), np.float32)], axis=0)
        ids.extend(missing_ids)
    texts = embedding_texts(mat)
    write_embedding_json(ids, texts, out_path)
    return dict(zip(ids, texts))


def write_image_shards(pairs: Iterable[Tuple[str, np.ndarray, np.ndarray, int]],
                       out_dir: str, shard_size: int = 1024,
                       prefix: str = "train_feat",
                       transformed: bool = False) -> List[str]:
    """(pair_id, img1, img2, label) records -> ``<prefix>_<n>.npz`` shards
    of ``shard_size`` pairs (``pair_ids``, ``images_1``, ``images_2``,
    ``labels`` int32, ``transformed``).  ``transformed`` marks images
    already cropped to the model's input (``prepare --only_image`` writes
    post-transform uint8); raw uint8 shards get an ``eval_transform`` when
    they are read.  uint8 shards are compressed, float ones are not (they
    barely compress)."""
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    buf: List[Tuple[str, np.ndarray, np.ndarray, int]] = []
    shard = 0

    def flush():
        nonlocal shard
        if not buf:
            return
        path = os.path.join(out_dir, f"{prefix}_{shard}.npz")
        img1 = np.stack([b[1] for b in buf])
        save = np.savez_compressed if img1.dtype == np.uint8 else np.savez
        save(
            path,
            pair_ids=np.array([b[0] for b in buf]),
            images_1=img1,
            images_2=np.stack([b[2] for b in buf]),
            labels=np.array([b[3] for b in buf], np.int32),
            transformed=np.bool_(transformed))
        paths.append(path)
        shard += 1
        buf.clear()

    for rec in pairs:
        buf.append(rec)
        if len(buf) == shard_size:
            flush()
    flush()
    return paths


def read_image_shards(paths: Sequence[str]):
    """Each shard as a dict of its arrays."""
    for path in paths:
        with np.load(path, allow_pickle=False) as z:
            yield {k: z[k] for k in z.files}


# ------------------------------------------------- detection-guided crop
# Per-category YOLO class whitelist — a data constant the crop pipeline
# must share with the reference (CATE2YOLO_CLASS, data_prepare.py:36-169).
CATE2YOLO_CLASS = {
    '手机保护套/壳': ['cell phone'], '手机': ['cell phone'],
    '空调': ['vase', 'cell phone', 'tv', 'microwave'],
    '微波炉': ['micro wave'], '电烤箱': ['microwave', 'oven'],
    '剃须刀': ['parking meter', 'mouse', 'remote'],
    '专业数码单反': ['cell phone', 'truck'],
    '洗烘套装': ['cell phone', 'oven', 'traffic light'],
    '养生壶/煎药壶': ['cup'],
    '电热毯/电热垫/电热地毯': ['bed', 'suitcase', 'tie', 'handbag'],
    '电热毯/水暖毯': ['bed'],
    '智能音箱': ['cell phone', 'sports ball', 'laptop', 'vase', 'bottle'],
    '茶吧机/泡茶机': ['refrigerator', 'oven'], '洗地机': ['truck', 'toaster'],
    '饮水机': ['refrigerator', 'cell phone', 'parking meter', 'laptop',
               'microwave'],
    '电磁炉/陶炉': ['cell phone', 'oven', 'toaster'],
    '游戏电竞头戴耳机': ['scissors', 'cup', 'airplane', 'truck'],
    '休闲裤': ['person'], '毛衣': ['person'], '帽子': ['person', 'kite'],
    '马丁靴': ['person', 'handbag', 'suitcase'],
    '金骏眉': ['bowl', 'dining table'], '传统黄酒': ['bottle', 'vase'],
    '驼奶及驼奶粉': ['book', 'cup', 'refrigerator', 'bottle'],
    '果酒': ['bottle'], '速溶咖啡': ['bottle', 'book'],
    '牛仔裤': ['person', 'tie', 'handbag', 'suitcase'],
    '休闲运动套装': ['person', 'bed'], '中老年女装': ['person', 'vase'],
    '半身裙': ['person', 'umbrella'], '男士包袋': ['suitcase', 'handbag'],
    '休闲皮鞋': ['handbag', 'person'], '时尚套装': ['person'],
    '蕾丝衫/雪纺衫': ['person', 'bed'], '时尚休闲鞋': ['cake', 'person'],
    '双肩背包': ['backpack', 'suitcase', 'handbag'],
    '毛针织衫': ['person', 'tie'], '围巾/丝巾/披肩': ['tie', 'person'],
    '旗袍': ['person'], '大码女装': ['person'],
    '板鞋': ['handbag', 'suitcase', 'cake', 'surfboard', 'skateboard'],
    '卫裤': ['person', 'handbag'], '瑞士腕表': ['clock'],
    '国产腕表': ['clock'], '衬衫': ['person'],
    '颈饰': ['person', 'cake', 'vase', 'sports ball', 'bottle', 'cup'],
    '投资贵金属': ['clock', 'frisbee', 'teddy bear', 'horse', 'vase'],
    '背心吊带': ['person', 'cake'], '日韩腕表': ['clock'],
    '钱包': ['suitcase', 'cell phone', 'handbag'],
    '电动自行车': ['bicycle', 'motorcycle'], '餐桌': ['dining table'],
    '收纳箱': ['suitcase', 'vase', 'refrigerator', 'oven', 'surfboard',
               'tv'],
    '碗': ['bowl', 'cup'], '炒锅': ['bowl'], '鲜花速递(同城)': ['potted plant'],
    '仓储货架': ['bench', 'bed'], '垃圾桶': ['cup', 'toilet', 'refrigerator'],
    '电脑椅': ['chair'], '茶几': ['dining table'], '化纤被': ['bed', 'person'],
    '茶道/零配': ['vase', 'bottle', 'bowl', 'knife'],
    '智能车机导航': ['cell phone', 'tv', 'car'],
    '乳胶床垫': ['bed', 'suitcase', 'laptop'],
    '普通坐便器': ['toilet', 'refrigerator'], '狗狗': ['dog', 'teddy bear'],
    '乳胶枕': ['keyboard', 'bed', 'remote', 'knife', 'surfboard',
               'suitcase', 'cake'],
    '弹簧床垫': ['bed', 'keyboard'], '羽绒/羽毛被': ['bed'],
    '桌布': ['dining table'], '书桌': ['dining table'],
    '椰棕床垫': ['bed', 'cake', 'keyboard'], '电脑桌': ['dining table'],
    '茶壶': ['vase', 'mouse'], '投影机': ['toaster', 'microwave', 'car'],
    '洗漱包': ['suitcase'], '摩托车整车': ['truck', 'motorcycle'],
    '护手霜': ['cup', 'book', 'bottle', 'frisbee', 'cell phonne'],
    '贴片面膜': ['book', 'bottle'],
    '隔离/妆前': ['bottle', 'toothbrush', 'refrigerator'],
    '洗发水': ['bottle'], '美甲工具': ['person', 'toothbrush', 'baseball bat'],
    '润唇膏': ['cup', 'bottle'], '男士面部乳霜': ['bottle', 'cell phone'],
    '电动牙刷': ['toothbrush'], '洗护套装': ['bottle', 'cup'],
    '涂抹面膜': ['cup', 'book', 'bottle', 'vase'],
    '化妆刷': ['knife', 'spoon', 'baseball bat', 'vase', 'toothbrush',
               'scissors', 'book'],
    '彩妆套装': ['suitcase'], '身体乳/霜': ['bottle'],
    '眼霜': ['cup', 'book', 'bottle', 'vase'], '指甲彩妆': ['bottle', 'person'],
    '私处保养': ['bottle', 'vase'], '脱毛膏': ['bottle', 'book', 'cup'],
    '男士护理套装': ['bottle', 'cell phone', 'microwave', 'refrigerator'],
    '棉柔巾': ['book', 'remote'], 'KTV/卡拉OK音箱': ['tv'],
    'DIY兼容机': ['microwave', 'traffic light'], '自热火锅': ['bowl'],
    '智能手环': ['cell phone'], '智能手表': ['cell phone'],
    '智能儿童手表': ['cell phone'], '茶生壶/煎药壶': ['cup'],
    '显示器': ['tv'],
    '女士脱毛/剃毛器': ['cell phone', 'toothbrush', 'vase', 'tennis racket'],
    '空气炸锅': ['oven', 'cell phone'],
    '麦克风/话筒': ['toothbrush', 'parking meter'],
    '空气净化器': ['refrigerator', 'cup'], '净水器': ['bottle'],
    '颈椎/腰椎按摩器': ['traffic light'],
    '颈椎按摩器': ['scissors', 'mouse', 'traffic light', 'handbag'],
    '键盘': ['keyboard'],
    '加湿器': ['vase', 'refrigerator', 'cup', 'cell phone'],
    '电子美容仪': ['vase', 'hair drier', 'scissors', 'toothbrush',
                   'cell phone'],
    '电热水壶': ['cup', 'microwave', 'refrigerator'],
    '电磁炉/掏炉': ['cell phone', 'toaster', 'oven'],
    '电吹风': ['hair drier', 'motorcycle'],
    '单反镜头': ['microwave', 'bottle', 'cell phone', 'book'],
    '除螨仪': ['mouse', 'cell phone'], '超声波迷你清洗机': ['cup'],
    '笔记本电脑': ['laptop'], '啤酒': ['bottle'],
}


def yolo_box_crop(img: np.ndarray, box: Sequence[float], gain: float = 1.02,
                  pad: float = 10.0) -> np.ndarray:
    """yolov5 ``save_one_box`` crop geometry: xyxy -> xywh, wh scaled by
    ``gain`` + ``pad`` pixels, back to xyxy, clipped, cropped. The
    reference saves crops through this helper (data_prepare.py:1486)."""
    h, w = img.shape[:2]
    x1, y1, x2, y2 = box[:4]
    cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
    bw = abs(x2 - x1) * gain + pad
    bh = abs(y2 - y1) * gain + pad
    x1n = int(max(cx - bw / 2, 0))
    y1n = int(max(cy - bh / 2, 0))
    x2n = int(min(cx + bw / 2, w))
    y2n = int(min(cy + bh / 2, h))
    if x2n <= x1n or y2n <= y1n:
        return img
    return img[y1n:y2n, x1n:x2n]


SALIENCY_CLASS = "__saliency__"  # class-agnostic box: bypasses the whitelist


def propose_box_saliency(img: np.ndarray, bg_tolerance: float = 30.0,
                         min_line_fraction: float = 0.01) -> List:
    """A class-agnostic box for a product on a plain background: the
    background colour is the median of the border, the foreground every
    pixel farther than ``bg_tolerance`` from it (max over channels), and
    the box spans the rows and columns with more than
    ``min_line_fraction`` foreground.  Returns ``[(x1, y1, x2, y2,
    SALIENCY_CLASS, 1.0)]``, or ``[]`` where there is no foreground or more
    than 90% of the image is foreground (the crop pass then copies the
    image, as the reference does below the crop ratio)."""
    h, w = img.shape[:2]
    flat = img.reshape(h, w, -1).astype(np.float32)
    border = np.concatenate([flat[0], flat[-1], flat[:, 0], flat[:, -1]])
    bg = np.median(border, axis=0)
    fg = np.abs(flat - bg).max(axis=-1) > bg_tolerance
    rows = np.where(fg.sum(axis=1) > min_line_fraction * w)[0]
    cols = np.where(fg.sum(axis=0) > min_line_fraction * h)[0]
    if rows.size == 0 or cols.size == 0:
        return []
    if fg.mean() > 0.9:  # full-bleed photo: "background" model is wrong
        return []
    y1, y2 = int(rows[0]), int(rows[-1]) + 1
    x1, x2 = int(cols[0]), int(cols[-1]) + 1
    return [(float(x1), float(y1), float(x2), float(y2),
             SALIENCY_CLASS, 1.0)]


def crop_images_with_boxes(item_info_path: str, images_dir: str,
                           out_dir: str, boxes: Dict[str, List],
                           min_crop_ratio: float = 0.1,
                           detector=None) -> Dict[str, int]:
    """Offline substitute for the reference's YOLOv5 ``object_detection``
    pass (data_prepare.py:1450-1505, which shells out to torch.hub and is
    not runnable offline): ``boxes`` maps item_id to detector outputs
    ``[x1, y1, x2, y2, class_name, confidence]`` precomputed by any
    detector. Picks the LARGEST box whose class is whitelisted for the
    item's category (CATE2YOLO_CLASS) and whose area ratio exceeds
    ``min_crop_ratio``; otherwise the original image is copied. Writes
    ``<item_id>.jpg`` files into ``out_dir``."""
    from PIL import Image

    os.makedirs(out_dir, exist_ok=True)
    stats = {"cropped": 0, "copied": 0, "missing": 0}
    with open(item_info_path, encoding="utf-8") as r:
        for line in r:
            d = json.loads(line)
            item_id = d["item_id"]
            name = d.get("item_image_name") or f"{item_id}.jpg"
            img = load_image(os.path.join(images_dir, name))
            if img is None:
                stats["missing"] += 1
                continue
            whitelist = CATE2YOLO_CLASS.get(d.get("cate_name", ""))
            out = img
            if whitelist is not None:
                h, w = img.shape[:2]
                dets = boxes.get(item_id)
                if dets is None and detector is not None:
                    # e.g. propose_box_saliency (offline YOLO fallback)
                    dets = detector(img)
                dets = sorted(dets or [],
                              key=lambda b: abs(b[3] - b[1]) * abs(b[2] - b[0]),
                              reverse=True)
                for det in dets:
                    if det[4] not in whitelist and det[4] != SALIENCY_CLASS:
                        continue
                    ratio = (abs(det[3] - det[1]) * abs(det[2] - det[0])
                             / float(h * w))
                    if ratio > min_crop_ratio:
                        out = yolo_box_crop(img, det)
                        break
            key = "cropped" if out is not img else "copied"
            stats[key] += 1
            Image.fromarray(out).save(
                os.path.join(out_dir, f"{item_id}.jpg"), quality=95)
    return stats


def crop_largest_detection(
    img: np.ndarray,
    detections: Sequence[Tuple[float, float, float, float, str, float]],
    class_whitelist: Optional[Sequence[str]] = None,
    min_crop_ratio: float = 0.1,
) -> np.ndarray:
    """Object-detection-guided crop (reference ``object_detection``,
    data_prepare.py:1450-1505): crop the LARGEST whitelisted box if its
    area ratio exceeds ``min_crop_ratio``, else return the original image.

    ``detections`` rows are (x1, y1, x2, y2, class_name, confidence) from
    any external detector (the reference shells out to torch.hub YOLOv5,
    which needs network access; here boxes arrive precomputed).  The
    per-category class whitelist corresponds to the reference's
    CATE2YOLO_CLASS table (data_prepare.py:36-169) supplied by the caller.
    """
    h, w = img.shape[:2]
    best = None
    best_area = 0.0
    for (x1, y1, x2, y2, cls, _conf) in detections:
        if class_whitelist is not None and cls not in class_whitelist:
            continue
        area = max(x2 - x1, 0) * max(y2 - y1, 0)
        if area > best_area:
            best_area = area
            best = (x1, y1, x2, y2)
    if best is None or best_area / float(h * w) <= min_crop_ratio:
        return img
    x1, y1, x2, y2 = (int(round(v)) for v in best)
    x1, y1 = max(x1, 0), max(y1, 0)
    x2, y2 = min(x2, w), min(y2, h)
    if x2 <= x1 or y2 <= y1:
        return img
    return img[y1:y2, x1:x2]
