"""Reference-shaped synthetic corpus for the port's dress rehearsal.

    python -m item_alignment_torch.pipeline.synth_corpus --output_dir DIR \
        [--with_nfnet_ckpt] [--seed N] [--n_items N ...]

The port's copy of ``scripts/make_synth_corpus.py``: the same flags and
the same numpy draws, so at one ``--seed`` and the same sizes it writes the
same bytes.  Under ``--output_dir`` it writes every raw artifact that
``pipeline/train.sh`` and ``pipeline/predict.sh`` read, by default at the
CCKS2022 reference's shape (about 65k labelled train pairs; the pkgm
config's 258k KG entities, about 3M triples and 1.4k relations):

- ``raw/item_info.jsonl``        (item_id, cate fields, title, item_pvs,
  sku_pvs, item_image_name): per-category pv-key distributions; listings
  of one product share most of their pvs (the learnable same-item signal)
- ``raw/item_train_pair.jsonl`` / ``item_valid_pair.jsonl`` /
  ``item_test_pair.jsonl``
- ``raw/item_images/<id>.jpg``   for the pairs of ``--n_image_pairs``
  (product-keyed patterns: same product, similar image)
- ``vocab/vocab.txt``            a wordpiece vocab covering the corpus
- ``item-align-{train,val,test}.json``  5-field rows for the legacy BERT
  member (src_/tgt_ prefixed fields and item_label)
- with ``--with_nfnet_ckpt``, ``pretrained/eca_nfnet_l0.bin``: a random
  eca_nfnet_l0 from ``--seed``, drawn on the port's own ``NFNet`` and saved
  by ``torch.save`` under timm 0.6.5's names and shapes
  (``utils/timm_import.convert_timm_nfnet`` gives the weights back exactly)

The images' per-listing noise is seeded by ``hash(item_id)``, as the JAX
generator's is, so their bytes repeat between runs only under one
``PYTHONHASHSEED``.  The corpus is synthetic: it proves the pipeline's
integrity and wall time at reference scale, not CCKS F1.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

# character pools for synthetic Chinese-like text
CHARS = list(
    "红蓝绿黑白金银灰紫粉咖啡机手表电脑手机箱包鞋服裙裤帽袜杯壶锅碗刀叉"
    "床桌椅柜灯扇琴鼓笔墨纸砚球拍网棋牌车轮胎灯门窗镜框珠链环扣布线绳带"
    "大小长短宽窄高低厚薄轻重新旧原装进口国产智能自动手动电动充电款式型"
    "号规格容量尺寸重量材质颜色品牌产地年份季节风格功能接口内存屏幕像素"
)
DIGITS = list("0123456789")
LATIN = list("abcdefghijklmnopqrstuvwxyz")


def _word(rng, lo=2, hi=4):
    return "".join(rng.choice(CHARS, rng.randint(lo, hi + 1)))


def _value(rng):
    """A pv value: word, alnum code, or number+unit."""
    kind = rng.randint(3)
    if kind == 0:
        return _word(rng, 2, 5)
    if kind == 1:
        return ("".join(rng.choice(LATIN, 2)).upper()
                + "".join(rng.choice(DIGITS, rng.randint(2, 5))))
    return "".join(rng.choice(DIGITS, rng.randint(1, 4))) + _word(rng, 1, 2)


def build_schema(rng, n_cates, n_keys, n_values):
    industries = [_word(rng) for _ in range(8)]
    keys = list(dict.fromkeys(_word(rng, 2, 3) for _ in range(n_keys * 2)))[:n_keys]
    values = list(dict.fromkeys(_value(rng) for _ in range(int(n_values * 1.3))))
    cates = []
    for c in range(n_cates):
        name = _word(rng, 2, 4) + str(c)
        k = rng.choice(len(keys), size=rng.randint(10, 22), replace=False)
        cates.append({
            "cate_id": f"c{c}", "cate_name": name,
            "industry_name": industries[c % len(industries)],
            "cate_name_path": industries[c % len(industries)] + "/" + name,
            "keys": [keys[i] for i in k],
        })
    return cates, values


def make_product(rng, cate, values):
    pv = {}
    for key in cate["keys"]:
        if rng.rand() < 0.85:
            pv[key] = values[rng.randint(len(values))]
    return {"cate": cate, "pv": pv,
            "title_core": _word(rng, 3, 6),
            "brand": values[rng.randint(len(values))]}


def make_listing(rng, product, item_id):
    """One item listing of a product: mostly the product's pvs with noise."""
    cate = product["cate"]
    pvs = []
    for k, v in product["pv"].items():
        if rng.rand() < 0.12:      # dropped key
            continue
        if rng.rand() < 0.06:      # perturbed value (still same product)
            v = v + DIGITS[rng.randint(10)]
        pvs.append(f"{k}#:#{v}")
    rng.shuffle(pvs)
    n_sku = min(rng.randint(0, 4), len(pvs))
    sku, item = pvs[:n_sku], pvs[n_sku:]
    title = (product["brand"] + product["title_core"]
             + cate["cate_name"] + _word(rng, 0, 2))
    return {
        "item_id": item_id,
        "industry_name": cate["industry_name"],
        "cate_id": cate["cate_id"], "cate_name": cate["cate_name"],
        "cate_name_path": cate["cate_name_path"],
        "title": title,
        "item_pvs": "#;#".join(item), "sku_pvs": "#;#".join(sku),
        "item_image_name": f"{item_id}.jpg",
    }


def make_pairs(rng, listings_by_product, products_by_cate, n_pairs, id_iter):
    """Label-balanced pairs: positives = two listings of one product,
    negatives = two products of the same category (hard) or cross-category
    (easy, 10%)."""
    pairs = []
    multi = [p for p, ls in listings_by_product.items() if len(ls) >= 2]
    cate_ids = list(products_by_cate)
    while len(pairs) < n_pairs:
        if len(pairs) % 2 == 0:
            p = multi[rng.randint(len(multi))]
            a, b = rng.choice(len(listings_by_product[p]), 2, replace=False)
            s, t = listings_by_product[p][a], listings_by_product[p][b]
            label = "1"
        else:
            if rng.rand() < 0.1:
                c1, c2 = rng.choice(len(cate_ids), 2, replace=False)
            else:
                c1 = c2 = rng.randint(len(cate_ids))
            ps1 = products_by_cate[cate_ids[c1]]
            ps2 = products_by_cate[cate_ids[c2]]
            p1 = ps1[rng.randint(len(ps1))]
            p2 = ps2[rng.randint(len(ps2))]
            if p1 == p2:
                continue
            s = listings_by_product[p1][rng.randint(len(listings_by_product[p1]))]
            t = listings_by_product[p2][rng.randint(len(listings_by_product[p2]))]
            label = "0"
        pairs.append({"id": next(id_iter), "src_item_id": s,
                      "tgt_item_id": t, "item_label": label})
    return pairs


def write_images(out_dir, item_ids, item_product, rng_seed, size=160):
    """Product-keyed synthetic jpgs: same product -> same base pattern plus
    per-listing noise (so the image towers have a learnable signal)."""
    from PIL import Image

    os.makedirs(out_dir, exist_ok=True)
    for iid in item_ids:
        prng = np.random.RandomState((hash(item_product[iid]) + rng_seed)
                                     % (2 ** 31))
        base = prng.randint(0, 255, (8, 8, 3), np.uint8)
        img = np.kron(base, np.ones((size // 8, size // 8, 1), np.uint8))
        noise = np.random.RandomState(
            (hash(iid) + rng_seed) % (2 ** 31)).randint(
            -20, 20, img.shape).astype(np.int16)
        img = np.clip(img.astype(np.int16) + noise, 0, 255).astype(np.uint8)
        Image.fromarray(img).save(os.path.join(out_dir, f"{iid}.jpg"),
                                  quality=85)


def bert_rows(pairs, items):
    rows = []
    for pr in pairs:
        row = {"item_label": pr["item_label"]}
        for side, iid in (("src", pr["src_item_id"]),
                          ("tgt", pr["tgt_item_id"])):
            it = items[iid]
            row[f"{side}_item_id"] = iid
            row[f"{side}_pvs"] = it["item_pvs"].replace("#:#", ":").replace(
                "#;#", ";")
            row[f"{side}_title"] = it["title"]
            row[f"{side}_cate"] = it["cate_name"]
            row[f"{side}_cate_path"] = it["cate_name_path"]
            row[f"{side}_industry_name"] = it["industry_name"]
        rows.append(row)
    return rows


def nfnet_tower():
    """The tower that ``build_model`` gives eca_nfnet_l0, on the CPU."""
    import torch

    from item_alignment_torch.config import ModelConfig
    from item_alignment_torch.models.image import backbone_for

    with torch.device("cpu"):
        return backbone_for("eca_nfnet_l0", ModelConfig())


def random_nfnet(seed: int):
    """A random eca_nfnet_l0 tower from ``seed``: He-normal kernels, every
    StdConv gain drawn from U(0.5, 1), so no residual branch starts at 0 as
    a pretrained one does not."""
    import torch

    from item_alignment_torch.models.image import StdConv, init_image_weights

    tower = nfnet_tower()
    gen = torch.Generator().manual_seed(seed)
    init_image_weights(tower, gen)
    with torch.no_grad():
        for m in tower.modules():
            if isinstance(m, StdConv):
                m.gain.uniform_(0.5, 1.0, generator=gen)
    return tower


def timm_nfnet_state_dict(tower) -> dict:
    """The port NFNet's weights under timm 0.6.5's ``eca_nfnet_l0`` names
    and shapes (the reverse of ``utils/timm_import.convert_timm_nfnet``),
    with a 1000-class ``head.fc`` as timm's has."""
    import torch

    out = {}
    for name, value in tower.state_dict().items():
        mod, leaf = name.rsplit(".", 1)
        if mod.startswith("stem"):
            mod = f"stem.conv{int(mod[4:]) + 1}"
        elif mod.startswith("stage"):
            stage, part = mod.split(".", 1)
            s, b = stage[len("stage"):].split("_block")
            part = "downsample.conv" if part == "downsample" else part
            mod = f"stages.{s}.{b}.{part}"
        if leaf == "gain":
            value = value.reshape(-1, 1, 1, 1)
        if leaf == "conv":  # ECA's Conv1d
            mod, leaf = f"{mod}.conv", "weight"
        out[f"{mod}.{leaf}"] = value.detach().cpu().clone()
    gen = torch.Generator().manual_seed(0)
    out["head.fc.weight"] = torch.randn(1000, tower.num_features,
                                        generator=gen) * 0.01
    out["head.fc.bias"] = torch.zeros(1000)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m item_alignment_torch.pipeline.synth_corpus",
        description=__doc__.splitlines()[0])
    p.add_argument("--output_dir", required=True)
    p.add_argument("--n_items", type=int, default=120_000)
    p.add_argument("--n_train_pairs", type=int, default=65_000)
    p.add_argument("--n_valid_pairs", type=int, default=2_000)
    p.add_argument("--n_test_pairs", type=int, default=5_000)
    p.add_argument("--n_image_pairs", type=int, default=4_000,
                   help="how many train pairs get raw images (valid/test "
                        "image pairs are added on top); the image-member "
                        "wall-clock extrapolates linearly")
    p.add_argument("--n_cates", type=int, default=50)
    p.add_argument("--n_keys", type=int, default=220)
    p.add_argument("--n_values", type=int, default=136_000,
                   help="distinct value strings; items+values+cates"
                        "+industries ~ 258k KG entities at the defaults")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--with_nfnet_ckpt", action="store_true",
                   help="also write pretrained/eca_nfnet_l0.bin (random "
                        "weights, timm-shape-exact) for the image steps")
    args = p.parse_args(argv)

    t0 = time.time()
    rng = np.random.RandomState(args.seed)
    out = args.output_dir
    raw = os.path.join(out, "raw")
    os.makedirs(raw, exist_ok=True)

    cates, values = build_schema(rng, args.n_cates, args.n_keys,
                                 args.n_values)
    # products per category, listings per product (avg ~3)
    n_products = args.n_items // 3
    products = [make_product(rng, cates[rng.randint(len(cates))], values)
                for _ in range(n_products)]
    print(f"[{time.time()-t0:.0f}s] {n_products} products")

    items = {}
    item_product = {}
    listings_by_product = {}
    i = 0
    while i < args.n_items:
        pid = rng.randint(n_products)
        iid = f"i{i}"
        items[iid] = make_listing(rng, products[pid], iid)
        item_product[iid] = pid
        listings_by_product.setdefault(pid, []).append(iid)
        i += 1
    with open(os.path.join(raw, "item_info.jsonl"), "w",
              encoding="utf-8") as w:
        for it in items.values():
            w.write(json.dumps(it, ensure_ascii=False) + "\n")
    # only products that actually got listings can appear in pairs
    products_by_cate = {}
    for pid in listings_by_product:
        cid = products[pid]["cate"]["cate_id"]
        products_by_cate.setdefault(cid, []).append(pid)
    print(f"[{time.time()-t0:.0f}s] {len(items)} item listings")

    pair_counter = iter(range(10 ** 9))
    splits = {
        "item_train_pair.jsonl": make_pairs(rng, listings_by_product,
                                            products_by_cate,
                                            args.n_train_pairs, pair_counter),
        "item_valid_pair.jsonl": make_pairs(rng, listings_by_product,
                                            products_by_cate,
                                            args.n_valid_pairs, pair_counter),
        "item_test_pair.jsonl": make_pairs(rng, listings_by_product,
                                           products_by_cate,
                                           args.n_test_pairs, pair_counter),
    }
    for fname, pairs in splits.items():
        with open(os.path.join(raw, fname), "w") as w:
            for pr in pairs:
                w.write(json.dumps({k: v for k, v in pr.items()
                                    if k != "id"}) + "\n")
    print(f"[{time.time()-t0:.0f}s] pairs written")

    # images for a slice of each split (image members scale linearly)
    img_items = set()
    for pairs, n in ((splits["item_train_pair.jsonl"], args.n_image_pairs),
                     (splits["item_valid_pair.jsonl"], args.n_image_pairs // 4),
                     (splits["item_test_pair.jsonl"], args.n_image_pairs // 4)):
        for pr in pairs[:n]:
            img_items.add(pr["src_item_id"])
            img_items.add(pr["tgt_item_id"])
    write_images(os.path.join(raw, "item_images"), sorted(img_items),
                 item_product, args.seed)
    print(f"[{time.time()-t0:.0f}s] {len(img_items)} images")

    # legacy bert json splits (same pairs, 5-field rows)
    for fname, pairs in (("item-align-train.json",
                          splits["item_train_pair.jsonl"]),
                         ("item-align-val.json",
                          splits["item_valid_pair.jsonl"]),
                         ("item-align-test.json",
                          splits["item_test_pair.jsonl"])):
        with open(os.path.join(out, fname), "w", encoding="utf-8") as w:
            for row in bert_rows(pairs, items):
                w.write(json.dumps(row, ensure_ascii=False) + "\n")

    # wordpiece vocab covering every char in the corpus
    charset = set(CHARS) | set(DIGITS) | set(LATIN)
    charset |= set("".join(c.upper() for c in LATIN))
    charset |= set("/#:;.,-_")
    vocab = (["[PAD]"] + [f"[unused{i}]" for i in range(1, 100)]
             + ["[UNK]", "[CLS]", "[SEP]", "[MASK]"]
             + sorted(charset) + ["<S>"])
    vd = os.path.join(out, "vocab")
    os.makedirs(vd, exist_ok=True)
    with open(os.path.join(vd, "vocab.txt"), "w", encoding="utf-8") as w:
        w.write("\n".join(vocab))
    os.makedirs(os.path.join(out, "pretrained"), exist_ok=True)
    if args.with_nfnet_ckpt:
        # random-weight eca_nfnet_l0 under timm's names and shapes, so the
        # timm-import path of train.sh steps 6a/7 runs offline (no real
        # pretrained weights ship with the repo)
        import torch
        torch.save(timm_nfnet_state_dict(random_nfnet(args.seed)),
                   os.path.join(out, "pretrained", "eca_nfnet_l0.bin"))
        print(f"[{time.time()-t0:.0f}s] synthetic eca_nfnet_l0.bin")

    n_ent_est = len(items) + args.n_values + args.n_cates + 8
    print(json.dumps({
        "items": len(items), "train_pairs": args.n_train_pairs,
        "test_pairs": args.n_test_pairs, "images": len(img_items),
        "vocab": len(vocab), "est_kg_entities": n_ent_est,
        "seconds": round(time.time() - t0, 1)}))


if __name__ == "__main__":
    main()
