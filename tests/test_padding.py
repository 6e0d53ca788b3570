"""Padding must be semantics-exact: identical answers, bit for bit."""

import dataclasses
import os

import numpy as np

from nbody import SimConfig, read_input
from nbody.models.direct_sum import run_problems_12
from nbody.physics import oscillation_table
from nbody.utils.padding import pad_scene, bucket_size

TESTCASE_DIR = "/root/reference/testcases"


def test_bucket_size():
    assert bucket_size(20) == 128
    assert bucket_size(128) == 128
    assert bucket_size(129) == 256
    assert bucket_size(1024) == 1024
    assert bucket_size(5000) == 6144


def test_padded_scene_structure():
    scene = read_input(os.path.join(TESTCASE_DIR, "b20.in"))
    padded = pad_scene(scene)
    assert padded.n == 128
    assert padded.device_cnt == 4
    assert list(padded.device_idx[:scene.device_cnt]) == list(scene.device_idx)
    assert (padded.m[scene.n:] == 0).all()
    # dummy device slots point at pad bodies
    assert (padded.device_idx[scene.device_cnt:] >= scene.n).all()


def test_padding_device_free_scene():
    """A zero-device scene must pad without touching any real body's mass —
    previously an IndexError when n already equaled a bucket size
    (device_idx[0] on an empty array)."""
    scene = read_input(os.path.join(TESTCASE_DIR, "b20.in"))
    bare = dataclasses.replace(scene, device_idx=scene.device_idx[:0],
                               types=["planet" if t == "device" else t
                                      for t in scene.types])
    # n_pad == 0 corner: already at a bucket size
    padded128 = pad_scene(dataclasses.replace(bare), n_target=None)
    at_bucket = pad_scene(padded128)          # n == 128 == bucket, 0 devices
    assert at_bucket.device_cnt == 0
    assert at_bucket.n == 128
    # and the normal path keeps zero device slots too
    p = pad_scene(bare)
    assert p.device_cnt == 0
    assert (p.m[scene.n:] == 0).all()


def test_padding_bitexact_answers():
    scene = read_input(os.path.join(TESTCASE_DIR, "b20.in"))
    cfg = dataclasses.replace(SimConfig(), n_steps=120)
    fst = oscillation_table(cfg)
    a = run_problems_12(scene, fst, cfg)
    b = run_problems_12(pad_scene(scene), fst, cfg)
    assert a.min_dist == b.min_dist           # bit-exact
    assert a.hit_time_step == b.hit_time_step
    D = scene.device_cnt
    assert list(a.arrivals) == list(b.arrivals[:D])
    np.testing.assert_array_equal(a.q_snaps, b.q_snaps[:D, :scene.n])
