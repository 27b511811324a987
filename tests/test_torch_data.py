"""The port's data layer against the JAX package's on the CPU.

PNG files are written with PIL (every colour type, palettes and grey
also below 8 bits, its own choice of row filters) and with the port's
writer (each of the five filters on every row); the port's reader must
equal PIL's convert("RGB") bit for bit. pil_resize must equal PIL's bilinear and
bicubic resize bit for bit. The transforms, datasets, the loader's epoch
and the caption datasets are held to JAX's on the same files and seeds:
images within one uint8 step (2 / 255 on [-1, 1], 0.8 / 255 on DALL-E's
rescale) with at most 1% of the values off by it (PIL rounds its
fixed-point filter weights; the port restates that rounding, so the two
agree exactly here), labels, token ids and index orders equal.
"""

import gzip
import io
import os
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from rqvae_tpu import data as jdata
from rqvae_tpu.data import loader as jloader
from rqvae_tpu.data import tokenizers as jtokenizers
from rqvae_tpu.data import transforms as jT
from rqvae_tpu.utils.config import Config as JConfig
from rqvae_tpu_torch import data as tdata
from rqvae_tpu_torch.data import image_io as IO
from rqvae_tpu_torch.data import loader as tloader
from rqvae_tpu_torch.data import tokenizers as ttokenizers
from rqvae_tpu_torch.data import transforms as tT
from rqvae_tpu_torch.utils.config import Config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MERGES = [("t", "h"), ("th", "e</w>"), ("a", "t</w>"), ("c", "at</w>"), ("s", "a"), ("sa", "t</w>"), ("o", "n</w>"),
          ("h", "e"), ("m", "a"), ("ma", "t</w>"), ("d", "o"), ("do", "g</w>")]
CAPTIONS = ["The cat sat on the mat.", "a DOG, the dog!!", "two cats & a dog on the mat at night", "", "the cat " * 30]


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """torch on one intra-op thread in this module (and in the modules that
    import this fixture): the suite runs several workers on the machine's
    cores, and a pool of one thread a core in each worker thrashes (the
    stage-1 CLI runs took 70x their time alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_within_one_step(got, want, step):
    """|got - want| <= one uint8 step everywhere, off by it on <= 1% of values."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    diff = np.abs(got - want)
    assert diff.max() <= step * (1 + 1e-4) + 1e-6
    assert (diff > 1e-6).mean() <= 0.01


def smooth_image(rng, h, w, c=3):
    low = rng.randint(0, 256, (h // 8 + 1, w // 8 + 1, c))
    img = np.repeat(np.repeat(low, 8, 0), 8, 1)[:h, :w] + rng.randint(-20, 21, (h, w, c))
    return img.clip(0, 255).astype(np.uint8)


def pil_rgb(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


# -- image_io ---------------------------------------------------------------------------------------------------


PALETTES = {"P": 200, "PT": 16, "P4": 4, "P2": 2}  # colours: 8-, 4-, 2- and 1-bit indices


def _pil_png(mode: str, rng) -> bytes:
    arr = smooth_image(rng, 37, 53, {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4, "LT": 1, "1": 1}.get(mode, 3))
    if mode in PALETTES:
        img = Image.fromarray(arr).quantize(PALETTES[mode])
        extra = {"transparency": 3} if mode == "PT" else {}
    elif mode == "1":
        img, extra = Image.fromarray(arr[..., 0], "L").convert("1"), {}
    elif mode == "LT":
        img, extra = Image.fromarray(arr[..., 0], "L"), {"transparency": 17}
    else:
        img, extra = Image.fromarray(arr[..., 0] if mode == "L" else arr, mode), {}
    buf = io.BytesIO()
    img.save(buf, "PNG", **extra)
    return buf.getvalue()


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "P", "PT", "P4", "P2", "LT", "1"])
def test_png_reader_equals_pil_for_each_colour_type(mode, tmp_path):
    """PIL writes grey, grey + alpha, RGB, RGBA, palettes of 8-, 4-, 2- and
    1-bit indices (with tRNS: PT), grey with tRNS (LT) and 1-bit grey,
    filtering each row as it chooses."""
    data = _pil_png(mode, np.random.RandomState(len(mode) * 7 + ord(mode[0])))
    want = pil_rgb(data)
    got = IO.read_image(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    path = tmp_path / "x.png"
    path.write_bytes(data)
    np.testing.assert_array_equal(IO.read_image(str(path)), want)


@pytest.mark.parametrize("row_filter", IO.FILTERS + ("adaptive",))
@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_png_reader_equals_pil_for_each_filter(row_filter, channels):
    rng = np.random.RandomState(channels)
    arr = smooth_image(rng, 19, 23, channels)
    arr[3] = rng.randint(0, 256, arr[3].shape)  # a noisy row: every byte wraps somewhere
    data = IO.encode_png(arr, row_filter)
    assert data[:8] == IO.PNG_SIGNATURE
    np.testing.assert_array_equal(IO.read_image(data), pil_rgb(data))


def _png_with_row_filters(arr: np.ndarray, kinds) -> bytes:
    """An 8-bit PNG of arr [H, W, C] whose row r is filtered with kinds[r]."""
    h, w, c = arr.shape
    every = IO._filtered(arr.reshape(h, w * c), c)
    raw = np.concatenate([np.asarray(kinds, np.uint8)[:, None], every[kinds, np.arange(h)]], axis=1)
    plain = IO.encode_png(arr, "none")
    idat = zlib.compress(raw.tobytes())
    chunk = struct.pack(">I", len(idat)) + b"IDAT" + idat + struct.pack(">I", zlib.crc32(b"IDAT" + idat))
    return plain[:33] + chunk + plain[-12:]  # the signature and IHDR, this IDAT, IEND


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_reader_equals_pil_with_every_filter_mixed(channels):
    """Rows of all five filters in a seeded order (None, Sub and Up rows
    inside the run that the Average / Paeth wavefront decodes, and ahead of
    it), on smooth rows and on noise that wraps every byte, and images one
    pixel wide and one row high."""
    rng = np.random.RandomState(10 + channels)
    for h, w in ((41, 29), (1, 17), (23, 1)):
        arr = smooth_image(rng, h, w, channels)
        arr[h // 3] = rng.randint(0, 256, arr[h // 3].shape)
        kinds = rng.randint(0, 5, h)
        kinds[: min(3, h)] = [0, 1, 2][: min(3, h)]
        data = _png_with_row_filters(arr, kinds)
        np.testing.assert_array_equal(IO.read_image(data), pil_rgb(data))
        np.testing.assert_array_equal(IO.read_image(data), np.repeat(arr, 3, axis=2) if channels == 1 else arr[..., :3])


def test_png_writer_adaptive_filters_follow_libpng():
    """Each row gets the filter whose bytes, as signed, sum to the least
    magnitude (ties to the lower filter), and the file reads back."""
    rng = np.random.RandomState(4)
    arr = smooth_image(rng, 40, 50)
    arr[7] = 9  # a flat row, and a noisy one
    arr[20] = rng.randint(0, 256, arr[20].shape)
    data = IO.encode_png(arr)
    rows = np.frombuffer(zlib.decompress(data[41:-16]), np.uint8).reshape(40, -1)
    every = IO._filtered(arr.reshape(40, -1), 3)
    cost = np.abs(every.view(np.int8).astype(np.int64)).sum(axis=2)
    np.testing.assert_array_equal(rows[:, 0], cost.argmin(axis=0))
    assert len(set(rows[:, 0].tolist())) > 1
    np.testing.assert_array_equal(IO.read_image(data), arr)


def test_png_reader_refusals(tmp_path):
    rng = np.random.RandomState(3)
    buf = io.BytesIO()
    Image.fromarray(smooth_image(rng, 20, 20), "RGB").save(buf, "PNG")
    data = bytearray(buf.getvalue())
    ihdr = data.index(b"IHDR")
    interlaced = bytearray(data)
    interlaced[ihdr + 16] = 1
    with pytest.raises(ValueError, match="interlaced"):
        IO.decode_png(bytes(interlaced))
    buf = io.BytesIO()
    Image.fromarray((rng.rand(8, 8) * 60000).astype(np.uint16)).save(buf, "PNG")  # 16-bit grey
    with pytest.raises(ValueError, match="16-bit"):
        IO.read_image(buf.getvalue())
    with pytest.raises(ValueError, match="not a PNG"):
        IO.decode_png(b"GIF89a")
    # other formats go through PIL where it is installed, and name the file without it
    jpg = tmp_path / "x.jpg"
    Image.fromarray(smooth_image(rng, 16, 24)).save(jpg)
    np.testing.assert_array_equal(IO.read_image(str(jpg)), np.asarray(Image.open(jpg).convert("RGB")))
    code = ("import sys; sys.modules['PIL'] = None\n"
            "from rqvae_tpu_torch.data.image_io import read_image\n"
            f"read_image({str(jpg)!r})\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and "ImportError" in res.stderr and "x.jpg" in res.stderr


# -- resize and transforms -------------------------------------------------------------------------------------


@pytest.mark.parametrize("resample", ["bilinear", "bicubic"])
@pytest.mark.parametrize("src,dst", [((375, 500), (256, 341)), ((60, 37), (256, 256)), ((300, 200), (300, 97)),
                                     ((33, 71), (64, 17))])
def test_pil_resize_equals_pil(resample, src, dst):
    img = smooth_image(np.random.RandomState(src[0]), *src)
    img[: src[0] // 3] = np.random.RandomState(1).randint(0, 256, img[: src[0] // 3].shape)  # hard edges: overshoot
    filt = Image.BILINEAR if resample == "bilinear" else Image.BICUBIC
    want = np.asarray(Image.fromarray(img).resize((dst[1], dst[0]), filt))
    got = tT.pil_resize(torch.from_numpy(img).permute(2, 0, 1), dst, resample).permute(1, 2, 0).numpy()
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


IMG_TYPES = [("imagenet256x256", "train"), ("imagenet256x256", "val"), ("ffhq64x64", "train"), ("ffhq64x64", "val"),
             ("LSUN-cat", "train"), ("none", "train")]
TXT_TYPES = [(t, s) for t in ("dalle", "dalle-vqvae", "clip", "clip-dvae", "none") for s in ("train", "valid")]


@pytest.mark.parametrize("ttype,split", IMG_TYPES + [("txt:" + t, s) for t, s in TXT_TYPES])
def test_transforms_equal_jax(ttype, split):
    """Each pipeline on three images (landscape, portrait, square) and three
    seeds each: the same crops, flips and resizes as JAX's on PIL images."""
    rng = np.random.RandomState(11)
    step = 2.0 / 255.0
    for h, w in ((300, 420), (410, 290), (80, 80)):
        img = smooth_image(rng, h, w)
        for seed in range(3):
            if ttype.startswith("txt:"):
                cfg = {"transforms": ttype[4:], "image_resolution": 64}
                port, jax_ = (m.create_txtimg_transforms(cfg, split) for m in (tT, jT))
                step = 0.8 / 255.0 if ttype[4:] in ("dalle", "clip-dvae") else 2.0 / 255.0
            else:
                cfg = {"transforms": {"type": ttype}}
                port, jax_ = (m.create_transforms(cfg, split) for m in (tT, jT))
            got = port(img, np.random.default_rng(seed))
            want = jax_(Image.fromarray(img), np.random.default_rng(seed))
            assert got.dtype == want.dtype == np.float32
            assert_within_one_step(got, want, step)


def test_random_resized_crop_fallback_and_crop_padding():
    """The centre fallback after ten misses (a strip no 1:1 crop of 75%+
    area fits), and crops past the edge read zeros, as PIL's."""
    img = smooth_image(np.random.RandomState(2), 20, 200)
    for seed in range(4):
        got = tT.random_resized_crop(img, 32, np.random.default_rng(seed), scale=(0.75, 1.0), ratio=(1.0, 1.0))
        want = jT.random_resized_crop(Image.fromarray(img), 32, np.random.default_rng(seed), scale=(0.75, 1.0),
                                      ratio=(1.0, 1.0))
        np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(tT.center_crop(img, 64), np.asarray(jT.center_crop(Image.fromarray(img), 64)))


# -- shard_indices, datasets and the loader ----------------------------------------------------------------------


@pytest.mark.parametrize("n,epoch,count,shuffle,seed", [(12, 0, 1, True, 0), (13, 3, 4, True, 7), (5, 1, 8, True, 0),
                                                        (10, 2, 3, False, 1), (1000, 9, 6, True, 123)])
def test_shard_indices_equal_jax(n, epoch, count, shuffle, seed):
    for rank in range(count):
        got = tloader.shard_indices(n, epoch, rank, count, shuffle, seed)
        want = jloader.shard_indices(n, epoch, rank, count, shuffle, seed)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def make_folder(root, n_classes=2, per_class=6, jpeg_at=None):
    """root/{train,val}/class_{c}/{i}.png: smooth seeded images of varied
    sizes; one JPEG where jpeg_at = (class, index)."""
    rng = np.random.RandomState(5)
    for split in ("train", "val"):
        for c in range(n_classes):
            d = os.path.join(root, split, f"class_{c}")
            os.makedirs(d)
            for i in range(per_class):
                img = smooth_image(rng, int(rng.randint(64, 300)), int(rng.randint(64, 300)))
                if (c, i) == jpeg_at:
                    Image.fromarray(img).save(os.path.join(d, f"{i:03d}.jpg"))
                else:
                    IO.write_png(os.path.join(d, f"{i:03d}.png"), img, ("sub", "up", "paeth")[i % 3])
    return root


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    return make_folder(str(tmp_path_factory.mktemp("imagenet")), jpeg_at=(1, 2))


def test_loader_epoch_equals_jax(folder):
    """Two epochs of a 12-image folder through imagenet256x256's train
    transforms, batches of 4: the same order, labels and images (the port's
    NCHW, JAX's NHWC)."""
    cfg = {"transforms": {"type": "imagenet256x256"}}
    port_ds = tdata.ImageFolder(os.path.join(folder, "train"), tT.create_transforms(cfg, "train"))
    jax_ds = jdata.ImageFolder(os.path.join(folder, "train"), jT.create_transforms(cfg, "train"))
    assert port_ds.items == jax_ds.items and len(port_ds) == 12
    port = tloader.DataLoader(port_ds, 4, shuffle=True, seed=3, num_workers=0)
    jax_ = jloader.DataLoader(jax_ds, 4, shuffle=True, seed=3, num_workers=1, process_index=0, process_count=1)
    assert len(port) == len(jax_) == 3
    for epoch in (0, 1):
        port.set_epoch(epoch)
        jax_.set_epoch(epoch)
        batches = list(zip(port, jax_, strict=True))
        assert len(batches) == 3
        for got, want in batches:
            assert got["images"].shape == (4, 3, 256, 256) and got["images"].dtype == torch.float32
            assert got["cond"].dtype == torch.int64
            np.testing.assert_array_equal(got["cond"].numpy(), want["cond"])
            assert_within_one_step(got["images"].permute(0, 2, 3, 1).numpy(), want["images"], 2.0 / 255.0)


def test_loader_val_sharding_and_workers(folder):
    """drop_last off (a ragged last batch), two processes' shards and worker
    processes give what shard_indices says, in order."""
    cfg = {"transforms": {"type": "imagenet256x256"}}
    ds = tdata.ImageFolder(os.path.join(folder, "val"), tT.create_transforms(cfg, "val"))
    loader = tloader.DataLoader(ds, 5, shuffle=False, drop_last=False, num_workers=0)
    got = [b["cond"].tolist() for b in loader]
    assert [len(b) for b in got] == [5, 5, 2] and len(loader) == 3
    assert sum(got, []) == [label for _, label in ds.items]
    for rank in range(2):
        shard = tloader.DataLoader(ds, 4, shuffle=True, seed=1, num_workers=2, process_index=rank, process_count=2)
        shard.set_epoch(4)
        labels = sum((b["cond"].tolist() for b in shard), [])
        want = tloader.shard_indices(12, 4, rank, 2, True, 1)  # 6 items: 3 batches of 2 a process
        assert labels == [ds.items[i][1] for i in want] and len(shard) == 3
        first = next(iter(shard))["images"]
        np.testing.assert_array_equal(first[0].permute(1, 2, 0).numpy(), ds[int(want[0])][0])
    with pytest.raises(ValueError, match="divisible"):
        tloader.DataLoader(ds, 5, process_count=2)


def test_datasets_equal_jax(folder, tmp_path, monkeypatch):
    """ImageFolder (with a JPEG), FFHQ with and without its list files,
    LSUN's plain-directory path and cat exception indices, Subset and
    create_dataset with its SMOKE_TEST truncation."""
    cfg = {"transforms": {"type": "ffhq64x64"}}
    pt, jt = tT.create_transforms(cfg, "train"), jT.create_transforms(cfg, "train")
    flat = tmp_path / "flat"
    flat.mkdir()
    rng = np.random.RandomState(8)
    for i in range(10):
        IO.write_png(str(flat / f"{i:02d}.png"), smooth_image(rng, 70, 90))
    pairs = [(tdata.ImageFolder(os.path.join(folder, "train"), pt, labels=False),
              jdata.ImageFolder(os.path.join(folder, "train"), jt, labels=False)),
             (tdata.FFHQ(str(flat), "val", pt), jdata.FFHQ(str(flat), "val", jt)),
             (tdata.LSUNClass(str(flat), pt, category="church"), jdata.LSUNClass(str(flat), jt, category="church"))]
    (flat / "ffhqtrain.txt").write_text("03.png\n07.png\n")
    pairs.append((tdata.FFHQ(str(flat), "train", pt), jdata.FFHQ(str(flat), "train", jt)))
    pairs.append((tdata.Subset(pairs[0][0], [5, 0, 11]), jdata.Subset(pairs[0][1], [5, 0, 11])))
    for port, jax_ in pairs:
        assert len(port) == len(jax_) > 0
        for epoch in (0, 2):
            port.set_epoch(epoch)
            jax_.set_epoch(epoch)
            for i in range(len(port)):
                (g, gl), (w, wl) = port[i], jax_[i]
                assert gl == wl
                assert_within_one_step(g, w, 2.0 / 255.0)
    assert [n for n, _ in pairs[3][0].items] == [str(flat / "03.png"), str(flat / "07.png")]
    cat = tdata.LSUNClass(str(flat), pt, category="cat")
    assert cat.exception_idx == jdata.LSUNClass.CAT_EXCEPTION_IDX
    (flat / "data.mdb").write_bytes(b"")
    monkeypatch.setitem(sys.modules, "lmdb", None)
    with pytest.raises(ImportError, match="lmdb"):
        tdata.LSUNClass(str(flat), pt)
    # create_dataset, and its SMOKE_TEST cut to 2 x total_batch_size items
    config = {"dataset": {"type": "imagenet", "root": folder, "transforms": {"type": "ffhq64x64"}},
              "experiment": {"total_batch_size": 2}}
    for smoke in ("0", "1"):
        monkeypatch.setenv("SMOKE_TEST", smoke)
        got, want = tdata.create_dataset(Config(config)), jdata.create_dataset(JConfig(config))
        for g, w in zip(got, want, strict=True):
            assert len(g) == len(w) == (4 if smoke == "1" else 12)
            for i in range(len(g)):
                assert g[i][1] == w[i][1]
                assert_within_one_step(g[i][0], w[i][0], 2.0 / 255.0)


# -- tokenizers and the caption datasets ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def merges_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("bpe")
    with gzip.open(d / "bpe_simple_vocab_16e6.txt.gz", "wt", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "\n".join(" ".join(m) for m in MERGES) + "\n")
    return str(d)


@pytest.fixture
def both_find(merges_dir, monkeypatch):
    """The merges file where both packages look: the port reads
    RQVAE_TPU_TOKENIZER_DIR at the call, JAX its module's _DEFAULT_DIRS."""
    monkeypatch.setenv("RQVAE_TPU_TOKENIZER_DIR", merges_dir)
    monkeypatch.setattr(jtokenizers, "_DEFAULT_DIRS", (merges_dir,))
    return merges_dir


def test_tokenizer_registry_equals_jax(both_find, monkeypatch):
    port = ttokenizers.prepare_tokenizer(ttokenizers.create_tokenizer("simple"), 16)
    jax_ = jtokenizers.prepare_tokenizer(jtokenizers.create_tokenizer("simple"), 16)
    assert port.token_to_id("[PAD]") == jax_.token_to_id("[PAD]")
    for text in CAPTIONS:
        ids = port.encode(text).ids
        assert ids == jax_.encode(text).ids and len(ids) == 16
    with pytest.raises(KeyError, match="unknown tokenizer"):
        ttokenizers.create_tokenizer("nope")
    monkeypatch.setitem(sys.modules, "tokenizers", None)
    for name in ttokenizers.HF_TOKENIZERS:
        with pytest.raises(ImportError, match="tokenizers"):
            ttokenizers.create_tokenizer(name)


def make_captions(root, n=6):
    """cc3m: {train,val}_list.txt over PNGs; coco: annotations json over
    images/val2014 (captions per image in file order, ids unsorted)."""
    rng = np.random.RandomState(9)
    os.makedirs(os.path.join(root, "cc3m", "imgs"))
    os.makedirs(os.path.join(root, "coco", "images", "val2014"))
    os.makedirs(os.path.join(root, "coco", "annotations"))
    for split in ("train", "val"):
        with open(os.path.join(root, "cc3m", f"{split}_list.txt"), "w") as f:
            for i in range(n):
                name = f"imgs/{split}_{i}.png"
                IO.write_png(os.path.join(root, "cc3m", name), smooth_image(rng, 70 + i, 90 - i))
                f.write(f"{name}\t{CAPTIONS[i % len(CAPTIONS)] or 'empty'} {i}\n")
    images, anns = [], []
    for k, img_id in enumerate((42, 7, 19, 3)):
        name = f"COCO_val2014_{img_id:012d}.png"
        IO.write_png(os.path.join(root, "coco", "images", "val2014", name), smooth_image(rng, 64, 80))
        images.append({"id": img_id, "file_name": name})
        for j in range(1 + k % 3):
            anns.append({"image_id": img_id, "caption": f"{CAPTIONS[(k + j) % 3]} number {j}"})
    with open(os.path.join(root, "coco", "annotations", "captions_val2014_30K_samples.json"), "w") as f:
        import json

        json.dump({"images": images, "annotations": anns}, f)
    return root


@pytest.mark.parametrize("name", ["cc3m", "coco"])
def test_caption_datasets_equal_jax(name, both_find, tmp_path, monkeypatch):
    """Items of Cc3m / Coco (images through the dalle-vqvae train pipeline,
    token ids), the *TextOnly and *RawTextOnly variants, and
    create_datasets."""
    root = os.path.join(make_captions(str(tmp_path)), name)
    cfg = {"transforms": "dalle-vqvae", "image_resolution": 64}
    pt, jt = tT.create_txtimg_transforms(cfg, "train"), jT.create_txtimg_transforms(cfg, "train")
    tcls, jcls = (getattr(m, "Cc3m" if name == "cc3m" else "Coco") for m in (tdata, jdata))
    split = "train" if name == "cc3m" else "val"
    port, jax_ = tcls(root, split, "simple", pt, context_length=12), jcls(root, split, "simple", jt, context_length=12)
    assert len(port) == len(jax_) > 0
    for i in range(len(port)):
        (g, gi), (w, wi) = port[i], jax_[i]
        assert gi.dtype == wi.dtype == np.int32
        np.testing.assert_array_equal(gi, wi)
        assert_within_one_step(g, w, 2.0 / 255.0)
    text_only = (getattr(tdata, f"{tcls.__name__}TextOnly")(root, "val", "simple", context_length=12),
                 getattr(jdata, f"{jcls.__name__}TextOnly")(root, "val", "simple", context_length=12))
    raw = (getattr(tdata, f"{tcls.__name__}RawTextOnly")(root, "val"),
           getattr(jdata, f"{jcls.__name__}RawTextOnly")(root, "val"))
    for i in range(len(raw[0])):
        assert raw[0][i] == raw[1][i]
        np.testing.assert_array_equal(text_only[0][i][1], text_only[1][i][1])
        assert text_only[0][i][0] == 0
    config = {"dataset": {"dataset": name, "root": root, "txt_tok_name": "simple", "context_length": 12,
                          "transforms": "clip", "image_resolution": 64}, "experiment": {"total_batch_size": 1}}
    monkeypatch.setenv("SMOKE_TEST", "1")
    for g, w in zip(tdata.create_datasets(Config(config)), jdata.create_datasets(JConfig(config)), strict=True):
        assert len(g) == len(w) == 2
        for i in range(2):
            np.testing.assert_array_equal(g[i][1], w[i][1])
            assert_within_one_step(g[i][0], w[i][0], 2.0 / 255.0)


def test_collate_of_text_and_text_only_items(both_find, tmp_path):
    root = os.path.join(make_captions(str(tmp_path)), "cc3m")
    ds = tdata.Cc3mTextOnly(root, "val", "simple", context_length=10)
    batch = tloader.default_collate([ds[i] for i in range(3)])
    want = jloader.default_collate([jdata.Cc3mTextOnly(root, "val", "simple", context_length=10)[i] for i in range(3)])
    assert batch["cond"].dtype == torch.int64 and batch["cond"].shape == (3, 10)
    np.testing.assert_array_equal(batch["cond"].numpy(), want["cond"])
    np.testing.assert_array_equal(batch["images"].numpy(), want["images"])
