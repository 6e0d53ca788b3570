import glob
import os

import numpy as np
import pytest

from nbody.io import read_input, format_output, parse_output

TESTCASE_DIR = "/root/reference/testcases"


def test_read_b20():
    scene = read_input(os.path.join(TESTCASE_DIR, "b20.in"))
    assert scene.n == 20
    assert scene.planet == 2
    assert scene.asteroid == 17
    assert scene.types[scene.planet] == "planet"
    assert scene.types[scene.asteroid] == "asteroid"
    assert scene.q.shape == (20, 3)
    assert scene.device_cnt >= 1
    assert all(scene.types[i] == "device" for i in scene.device_idx)
    # first body of b20 is a black hole at a known position
    assert scene.types[0] == "black_hole"
    assert scene.q[0, 0] == -1.5808194255286899e+08


def test_all_testcases_parse():
    for path in sorted(glob.glob(os.path.join(TESTCASE_DIR, "*.in"))):
        scene = read_input(path)
        assert scene.n == int(os.path.basename(path)[1:-3])
        assert np.isfinite(scene.q).all() and np.isfinite(scene.v).all()
        assert (scene.m >= 0).all()
        # graded cases have 2-4 devices (SURVEY.md §4)
        assert 1 <= scene.device_cnt <= 8


@pytest.mark.parametrize("name", ["b20", "b30", "b1024"])
def test_output_format_roundtrips_golden(name):
    """Our formatter must reproduce the golden files byte-for-byte when fed
    the golden values (same contract as hw5.cu:133-141)."""
    with open(os.path.join(TESTCASE_DIR, f"{name}.out")) as f:
        golden = f.read()
    vals = parse_output(golden)
    assert format_output(*vals) == golden


def test_device_mask():
    scene = read_input(os.path.join(TESTCASE_DIR, "b20.in"))
    mask = scene.device_mask()
    assert mask.sum() == scene.device_cnt
    assert set(np.nonzero(mask)[0]) == set(scene.device_idx)


def test_parse_output_rejects_malformed():
    import pytest

    from nbody.io import SceneFormatError
    for bad in ("", "1.0\n5", "1.0\n5\n3", "1.0\nx\n3 2.0",
                "1.0\n5\n3 2.0 extra", "1.0\n5\n3 2.0\n4th line"):
        with pytest.raises(SceneFormatError):
            parse_output(bad)
