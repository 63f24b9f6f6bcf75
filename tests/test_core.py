import os

import numpy as np

from pim.core import cvars  # noqa: F401 — registers the engine cvars
from pim.core.cmd import CmdStat, CmdSystem, cmd_getopt
from pim.core.crate import Crate
from pim.core.cvar import CVarType, cvar, get_registry
from pim.core.guid import guid_from_str


def test_cvar_clamp_and_dirty():
    cv = cvar("test_float", CVarType.Float, 1.0, "t", 0.0, 2.0)
    v0 = cv.version
    cv.set(5.0)
    assert cv.get() == 2.0
    dirty, v1 = cv.check_dirty(v0)
    assert dirty and v1 != v0
    dirty, _ = cv.check_dirty(v1)
    assert not dirty
    # setting same value does not dirty
    cv.set(2.0)
    assert cv.version == v1


def test_cvar_vector_parse():
    cv = cvar("test_vec", CVarType.Vector, (1, 0, 0, 0))
    cv.set_str("0.5, 0.25 0.125")
    assert cv.get() == (0.5, 0.25, 0.125, 0.0)


def test_cvar_save_load(tmp_path):
    from pim.core.cvar import CVarFlag

    cv = cvar("test_saved", CVarType.Int, 7, flags=CVarFlag.SAVE)
    cv.set(42)
    path = str(tmp_path / "cvars.json")
    get_registry().save(path)
    cv.set(7)
    assert get_registry().load(path)
    assert cv.get() == 42


def test_cmd_queue_wait_semantics():
    sys = CmdSystem()
    log = []
    sys.reg("mark", lambda argv: (log.append(argv[1]), CmdStat.OK)[1])
    sys.enqueue("mark a; wait 2; mark b")
    sys.update()  # executes a, hits wait
    assert log == ["a"]
    sys.update()  # waiting
    assert log == ["a"]
    sys.update()  # wait expired -> b
    assert log == ["a", "b"]
    assert not sys.pending()


def test_cmd_cvar_fallback():
    sys = CmdSystem()
    cv = cvar("test_fb", CVarType.Float, 1.0)
    assert sys.immediate("test_fb 3.5") == CmdStat.OK
    assert cv.get() == 3.5


def test_cmd_getopt():
    assert cmd_getopt(["pt_test", "-frames", "100"], "frames") == "100"
    assert cmd_getopt(["pt_test"], "frames") is None


def test_guid_stable():
    g = guid_from_str("sky")
    assert g == guid_from_str("sky")
    assert g != guid_from_str("sky2")
    assert guid_from_str("") == 0


def test_crate_roundtrip(tmp_path):
    c = Crate()
    c.set("lightmap0", {"texels": np.arange(12, dtype=np.float32).reshape(3, 4),
                        "sample_counts": np.ones((3,), np.int32),
                        "name": "lm0", "version": 3})
    c.set("entities", [np.zeros((2, 3)), ("a", "b")])
    path = str(tmp_path / "test.crate")
    c.save(path)
    c2 = Crate.load(path)
    lm = c2.get("lightmap0")
    np.testing.assert_array_equal(lm["texels"], np.arange(12, dtype=np.float32).reshape(3, 4))
    assert lm["name"] == "lm0" and lm["version"] == 3
    ents = c2.get("entities")
    assert isinstance(ents, list) and ents[1] == ("a", "b")
    assert c2.get("missing") is None
