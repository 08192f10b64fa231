"""The port's YOLOv5 helpers (``data/yolo.py``) vs the JAX package's copy:
the cases of ``tests/test_yolo.py`` through both, results equal, the
TorchScript detector included (a scripted module that emits fixed
[1, N, 85] predictions stands in for YOLOv5 weights)."""

import numpy as np
import pytest
import torch

from item_alignment_torch.data import yolo as T

pytest.importorskip("jax")
from item_alignment_tpu.data import yolo as J  # noqa: E402

torch.set_num_threads(1)
N_CLS = len(J.COCO80_CLASSES)


def test_classes_and_letterbox_equal():
    assert T.COCO80_CLASSES == J.COCO80_CLASSES
    rs = np.random.RandomState(0)
    for h, w, size in ((300, 600, 640), (1280, 960, 640), (333, 517, 320),
                       (50, 70, 64)):
        img = rs.randint(0, 256, (h, w, 3)).astype(np.uint8)
        ours, gain, pad = T.letterbox(img, size)
        theirs, jgain, jpad = J.letterbox(img, size)
        np.testing.assert_array_equal(ours, theirs)
        assert (gain, pad) == (jgain, jpad)
    out, gain, pad = T.letterbox(np.zeros((300, 600, 3), np.uint8), 640)
    assert out.shape == (320, 608, 3) and gain == 1.0 and pad == (4.0, 10.0)


def test_nms_decode_and_scale_equal():
    boxes = np.array([[0, 0, 10, 10], [1, 1, 11, 11], [50, 50, 60, 60]],
                     np.float32)
    scores = np.array([0.9, 0.8, 0.7], np.float32)
    assert T.nms(boxes, scores, 0.45) == J.nms(boxes, scores, 0.45) == [0, 2]

    rs = np.random.RandomState(1)
    rows = np.zeros((40, 5 + N_CLS), np.float32)
    rows[:, :2] = rs.uniform(20, 300, (40, 2))
    rows[:, 2:4] = rs.uniform(5, 80, (40, 2))
    rows[:, 4] = rs.uniform(0, 1, 40)
    rows[np.arange(40), 5 + rs.randint(0, N_CLS, 40)] = rs.uniform(0, 1, 40)
    rows[:4, 5 + J.COCO80_CLASSES.index("cup")] = 0.95  # overlapping cups
    rows[:4, :4] = [100, 100, 40, 40]
    for conf in (0.1, 0.25, 0.6):
        ours = T.decode_predictions(rows, conf_thres=conf)
        assert ours == J.decode_predictions(rows, conf_thres=conf)
        assert T.scale_boxes(ours, 0.5, (4.0, 10.0), (300, 200)) == \
            J.scale_boxes(ours, 0.5, (4.0, 10.0), (300, 200))
    assert T.decode_predictions(rows[:0]) == []


def test_torchscript_detector_equal(tmp_path):
    phone = J.COCO80_CLASSES.index("cell phone")

    class Fixed(torch.nn.Module):
        def __init__(self):
            super().__init__()
            pred = torch.zeros(1, 3, 5 + N_CLS)
            pred[0, 0, 0:4] = torch.tensor([160.0, 120.0, 80.0, 80.0])
            pred[0, 0, 4] = 0.9
            pred[0, 0, 5 + phone] = 0.9
            pred[0, 1, 0:4] = torch.tensor([162.0, 122.0, 80.0, 80.0])
            pred[0, 1, 4] = 0.5
            pred[0, 1, 5 + phone] = 0.9
            self.pred = torch.nn.Parameter(pred, requires_grad=False)

        def forward(self, x):
            assert x.ndim == 4 and x.shape[1] == 3
            assert float(x.max()) <= 1.0
            return self.pred

    path = str(tmp_path / "fake_yolo.torchscript.pt")
    torch.jit.script(Fixed()).save(path)
    img = np.zeros((640, 1280, 3), np.uint8)
    ours = T.YoloTorchscriptDetector(path, imgsz=640)(img)
    assert ours == J.YoloTorchscriptDetector(path, imgsz=640)(img)
    (x1, y1, x2, y2, name, conf), = ours
    assert name == "cell phone" and conf == pytest.approx(0.81)
    assert (x1, y1, x2, y2) == (240.0, 160.0, 400.0, 320.0)
