"""Task file resolvers (ref dataset.py:75-191), the port of the JAX
package's ``data/resolvers.py``, with the three resolvers the reference
lost (get_cars/get_chairs/get_faces_3d exist only as a TODO at
dataset.py:264-266 while angle_pairing.py:17-20 imports them). Their
signatures come from the call sites (angle_pairing.py:74-109) and their
behavior from the original DiscoGAN tasks: azimuth sweeps split into the
first and last half of the rotation.

``read_attr_file`` parses CelebA's ``list_attr_celeba.txt`` in plain
Python (the JAX package builds a pandas DataFrame; the card's host has no
pandas) and selects the same rows in the same order. The ``synthetic``
task (seeded random data) is an extension for runs without a dataset.
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from .paths import task_paths
from .preprocess import read_images


def read_attr_file(attr_path, image_dir) -> list:
    """list_attr_celeba.txt (a count line, the attribute names, then one
    line per image, "<file> <1|-1> ...") -> one dict a row, in file order,
    of "image_path" and each attribute's "1"/"-1" (ref dataset.py:75-86)."""
    with open(attr_path, "r") as f:
        lines = [line.split() for line in f.read().splitlines()]
    columns = ["image_path"] + lines[1]
    rows = [dict(zip(columns, items)) for items in lines[2:] if items]
    for row in rows:
        row["image_path"] = os.path.join(image_dir, row["image_path"])
    return rows


def get_celebA_files(style_A: str, style_B: Optional[str], constraint: Optional[str],
                     constraint_type: Optional[str], test: bool = False,
                     n_test: int = 200) -> Tuple[np.ndarray, np.ndarray]:
    """Attribute-split resolver (ref dataset.py:88-114): A = the style_A == 1
    rows, B = style_B == 1 if given else style_A == -1, after the optional
    constraint == constraint_type filter; the last n_test rows are the test
    split."""
    paths = task_paths()["celebA"]
    rows = read_attr_file(paths / "list_attr_celeba.txt",
                          str(paths / "img_align_celeba"))
    if constraint:
        rows = [r for r in rows if r.get(constraint) == constraint_type]

    def select(attr, value):
        return np.array([r["image_path"] for r in rows if r.get(attr) == value],
                        dtype=object)

    style_A_data = select(style_A, "1")
    style_B_data = select(style_B, "1") if style_B else select(style_A, "-1")
    if not test:
        return style_A_data[:-n_test], style_B_data[:-n_test]
    return style_A_data[-n_test:], style_B_data[-n_test:]


def get_edge2photo_files(item: str = "edges2shoes", test: bool = False):
    """Returns the SAME sorted jpg list for both domains — the A/B split
    happens at decode time via the left/right crop (ref dataset.py:116-141)."""
    paths = task_paths()
    if item not in ("edges2shoes", "edges2handbags"):
        raise ValueError(f"지원되지 않는 아이템: {item}")
    path = Path(paths[item]) / ("test" if test else "train")
    if not path.exists():
        raise FileNotFoundError(f"경로를 찾을 수 없습니다: {path}")
    files = [str(f) for f in sorted(path.glob("*.jpg"))]
    if not files:
        raise ValueError(f"'{path}' 경로에서 이미지 파일을 찾을 수 없습니다.")
    return files, files


def get_facescrub_files(test: bool = False, n_test: int = 200):
    """male = paths containing 'actors', female = 'actresses'
    (ref dataset.py:143-169)."""
    root = task_paths()["facescrub"]
    if not root.exists():
        raise FileNotFoundError(f"FaceScrub 데이터셋 경로를 찾을 수 없습니다: {root}")
    all_images = []
    for ext in ("*.jpg", "*.png"):
        all_images.extend(root.glob(f"**/{ext}"))
    all_images = sorted(str(p) for p in all_images)
    if not all_images:
        raise ValueError(f"'{root}' 경로에서 이미지 파일을 찾을 수 없습니다.")
    male = [p for p in all_images if "actors" in p.lower()]
    female = [p for p in all_images if "actresses" in p.lower()]
    if test:
        return male[-n_test:], female[-n_test:]
    return male[:-n_test], female[:-n_test]


def get_custom_data(item_a: str = "tops", item_b: str = "hanbok",
                    test: bool = False, image_size: int = 512):
    """datasets/custom/<item>/{train,test}/*.{jpg,png} (ref dataset.py:171-191)."""
    custom = task_paths()["custom"]
    sub = "test" if test else "train"
    data_A_path = custom / item_a / sub
    data_B_path = custom / item_b / sub
    data_A = [str(f) for f in data_A_path.glob("*.jpg")] + [str(f) for f in data_A_path.glob("*.png")]
    data_B = [str(f) for f in data_B_path.glob("*.jpg")] + [str(f) for f in data_B_path.glob("*.png")]
    if not data_A or not data_B:
        raise ValueError(f"데이터셋을 찾을 수 없습니다: {data_A_path} 또는 {data_B_path}")
    print(f"데이터셋 로드 완료: A({len(data_A)}개), B({len(data_B)}개)")
    return np.array(data_A), np.array(data_B)


# --- Rendered-view resolvers (restored; ref dataset.py:264-266 TODO) -------

_ANGLE_RE = re.compile(r"(\d+)")


def _angle_of(path: str) -> int:
    """Last integer in the filename stem is the azimuth index."""
    nums = _ANGLE_RE.findall(Path(path).stem)
    return int(nums[-1]) if nums else 0


def _angle_split(files, ver: int, half: Optional[str], test: bool, test_frac=0.1):
    """Split an azimuth sweep: keep angles < ver; 'first'/'last' half of the
    rotation range; tail fraction of the sorted list is the test split."""
    files = sorted(files, key=lambda p: (str(Path(p).parent), _angle_of(p)))
    files = [f for f in files if _angle_of(f) < ver]
    if half == "first":
        files = [f for f in files if _angle_of(f) < ver // 2]
    elif half == "last":
        files = [f for f in files if _angle_of(f) >= ver // 2]
    n_test = max(1, int(len(files) * test_frac)) if files else 0
    return files[-n_test:] if test else files[:-n_test]


def get_cars(test: bool = False, ver: int = 180, half: Optional[str] = None,
             image_size: int = 64):
    """Rendered car sweep under datasets/data/cars. Returns PRE-DECODED
    arrays — car2car consumes the data without read_images
    (angle_pairing.py:277-287)."""
    root = task_paths()["cars"]
    files = [str(p) for ext in ("*.jpg", "*.png") for p in root.glob(f"**/{ext}")]
    if not files:
        raise FileNotFoundError(f"자동차 데이터셋을 찾을 수 없습니다: {root}")
    split = _angle_split(files, ver, half, test)
    return read_images(split, None, image_size)


def get_chairs(test: bool = False, half: Optional[str] = None, ver: int = 360,
               image_size: int = 64):
    """Rendered chair sweep under datasets/rendered_chairs. Returns paths
    (consumed through read_images at angle_pairing.py:283-287)."""
    root = task_paths()["rendered_chairs"]
    files = [str(p) for ext in ("*.jpg", "*.png") for p in root.glob(f"**/{ext}")]
    if not files:
        raise FileNotFoundError(f"의자 데이터셋을 찾을 수 없습니다: {root}")
    return np.array(_angle_split(files, ver, half, test))


def get_faces_3d(test: bool = False, half: Optional[str] = None,
                 ver: int = 180):
    """3D face renderings under datasets/PublicMM1/05_renderings; paths."""
    root = task_paths()["face_3d"]
    files = [str(p) for ext in ("*.jpg", "*.png") for p in root.glob(f"**/{ext}")]
    if not files:
        raise FileNotFoundError(f"3D 얼굴 데이터셋을 찾을 수 없습니다: {root}")
    return np.array(_angle_split(files, ver, half, test))


# --- Task dispatch ---------------------------------------------------------

EDGE_TASKS = ("edges2shoes", "edges2handbags")
PHOTO_PAIR_TASKS = ("handbags2shoes", "shoes2handbags")
ANGLE_TASKS = ("car2car", "face2face", "chair2chair", "chair2car",
               "chair2face", "car2face")


def task_domains(task_name: str):
    """Decode-time domain tags for (A, B) (ref image_translation.py:241-249,
    :321-329)."""
    if task_name.startswith("edges2"):
        return "A", "B"
    if task_name in PHOTO_PAIR_TASKS:
        return "B", "B"
    return None, None


def get_task_data(args):
    """get_data dispatch covering both trainers (ref image_translation.py:
    83-134 and angle_pairing.py:74-109). Returns (data_A, data_B, test_A,
    test_B) — entries are path arrays, or pre-decoded arrays for car data
    and the synthetic task."""
    task = args.task_name
    n_test = getattr(args, "n_test", 200)
    if task == "synthetic":
        from .pipeline import synthetic_pair

        data_A, data_B = synthetic_pair(256, args.image_size, seed=0)
        test_A, test_B = synthetic_pair(8, args.image_size, seed=1)
        return data_A, data_B, test_A, test_B
    if task == "facescrub":
        return (*get_facescrub_files(False, n_test), *get_facescrub_files(True, n_test))
    if task == "celebA":
        kw = dict(style_A=args.style_A, style_B=args.style_B,
                  constraint=args.constraint, constraint_type=args.constraint_type,
                  n_test=n_test)
        return (*get_celebA_files(test=False, **kw), *get_celebA_files(test=True, **kw))
    if task in EDGE_TASKS:
        return (*get_edge2photo_files(task, False), *get_edge2photo_files(task, True))
    if task in PHOTO_PAIR_TASKS:
        # handbags2shoes: A=handbags, B=shoes (ref image_translation.py:
        # 109-120). The reference has no shoes2handbags branch in get_data
        # despite handling its domains at :244 — it would crash with an
        # UnboundLocalError; here it is the swapped pairing.
        a_item, b_item = (("edges2handbags", "edges2shoes")
                          if task == "handbags2shoes"
                          else ("edges2shoes", "edges2handbags"))
        a1, a2 = get_edge2photo_files(a_item, False)
        ta1, ta2 = get_edge2photo_files(a_item, True)
        b1, b2 = get_edge2photo_files(b_item, False)
        tb1, tb2 = get_edge2photo_files(b_item, True)
        return (np.hstack([a1, a2]), np.hstack([b1, b2]),
                np.hstack([ta1, ta2]), np.hstack([tb1, tb2]))
    if task in ("tops2hanbok", "hanbok2tops"):
        item_a, item_b = (("tops", "hanbok") if task == "tops2hanbok"
                          else ("hanbok", "tops"))
        return (*get_custom_data(item_a, item_b, False, args.image_size),
                *get_custom_data(item_a, item_b, True, args.image_size))
    if task == "car2car":
        data_A = get_cars(False, 180, "first", args.image_size)
        data_B = get_cars(False, 180, "last", args.image_size)
        t = get_cars(True, 180, None, args.image_size)
        return data_A, data_B, t, t
    if task == "face2face":
        return (get_faces_3d(False, "first"), get_faces_3d(False, "last"),
                get_faces_3d(True), get_faces_3d(True))
    if task == "chair2chair":
        return (get_chairs(False, "first", 360), get_chairs(False, "last", 360),
                get_chairs(True, ver=360), get_chairs(True, ver=360))
    if task == "chair2car":
        return (get_chairs(False, None, 180), get_cars(False, 180, None, args.image_size),
                get_chairs(True, ver=180), get_cars(True, 180, None, args.image_size))
    if task == "chair2face":
        return (get_chairs(False, None, 180), get_faces_3d(False, None),
                get_chairs(True, ver=180), get_faces_3d(True))
    if task == "car2face":
        return (get_cars(False, 180, None, args.image_size), get_faces_3d(False, None),
                get_cars(True, 180, None, args.image_size), get_faces_3d(True))
    raise ValueError(f"unknown task_name: {task}")
