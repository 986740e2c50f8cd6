"""PyTorch port's example codec and replay buffer against `tak_tpu.examples`.

The codec on the first 200 lines of the committed 5x5 self-play buffer
(`runs/train5_r3/_checkpoint/buffer.data`): read by both packages, the
fields are equal, and writing them back gives the file's line byte for
byte on both sides.
"""

from pathlib import Path

import numpy as np
import torch

from tak_tpu.engine.core import get_engine as jax_engine
from tak_tpu.examples import Example as JaxExample
from tak_tpu.examples import example_to_line as jax_example_to_line
from tak_tpu.examples import line_to_example as jax_line_to_example
from tak_tpu.examples import stack_states as jax_stack_states
from tak_tpu_torch.engine.core import get_engine
from tak_tpu_torch.examples import (
    Example,
    ReplayBuffer,
    example_to_line,
    line_to_example,
    stack_states,
)
from tak_tpu_torch.types import FIELDS

BUFFER = (Path(__file__).resolve().parents[1]
          / "runs/train5_r3/_checkpoint/buffer.data")


def _lines(count=200):
    with open(BUFFER) as f:
        return [next(f).rstrip("\n") for _ in range(count)]


def test_codec_matches_jax_on_the_buffer():
    engine, jengine = get_engine(5), jax_engine(5)
    for line in _lines():
        got = line_to_example(engine, line)
        want = jax_line_to_example(jengine, line)
        assert example_to_line(engine, got) == line
        assert jax_example_to_line(jengine, want) == line
        assert got.state.keys() == want.state.keys()
        for k, v in want.state.items():
            np.testing.assert_array_equal(got.state[k], v, err_msg=k)
        np.testing.assert_array_equal(got.actions, want.actions)
        np.testing.assert_array_equal(got.visits, want.visits)
        assert got.result == want.result
        # the port's writer on the JAX package's example, and back
        assert example_to_line(engine, Example(**vars(want))) == line


def test_fractional_results_format_as_jax():
    engine, jengine = get_engine(5), jax_engine(5)
    ex = line_to_example(engine, _lines(1)[0])
    for result in (0.5, -0.25, 1.0, 0.0, -1.0):
        ex.result = result
        assert example_to_line(engine, ex) == jax_example_to_line(
            jengine, JaxExample(**vars(ex)))


def test_policy_dense_and_stack_states_match_jax():
    engine, jengine = get_engine(5), jax_engine(5)
    exs = [line_to_example(engine, l) for l in _lines(16)]
    jexs = [JaxExample(**vars(e)) for e in exs]
    for e, j in zip(exs, jexs):
        np.testing.assert_array_equal(e.policy_dense(engine.num_actions),
                                      j.policy_dense(jengine.num_actions))
    got = stack_states(exs, "cpu").to_numpy()
    want = jax_stack_states(jexs)
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], np.asarray(getattr(want, f)),
                                      err_msg=f)
    assert stack_states(exs, "cpu").heights.device == torch.device("cpu")


def test_replay_buffer_window_and_save_load(tmp_path):
    engine = get_engine(5)
    buf = ReplayBuffer(max_examples=5)
    buf.extend([line_to_example(engine, l) for l in _lines(8)])
    buf.truncate()
    assert len(buf) == 5
    assert [example_to_line(engine, e) for e in buf.examples] == _lines(8)[3:]
    path = str(tmp_path / "ex.data")
    buf.save(engine, path)
    assert Path(path).read_text() == "".join(l + "\n" for l in _lines(8)[3:])
    again = ReplayBuffer()
    again.load(engine, path)
    assert len(again) == 5
    for a, b in zip(buf.examples, again.examples):
        np.testing.assert_array_equal(a.actions, b.actions)
        np.testing.assert_array_equal(a.visits, b.visits)
        assert a.result == b.result


def test_ptn_index_matches_parsing():
    """`Tables.ptn_to_action` looks canonical PTN up in an index: every
    action's PTN maps back to it at every size, as parsing does and as the
    JAX package's tables do; other spellings still parse."""
    for n in range(3, 9):
        tables, jtables = get_engine(n).tables, jax_engine(n).tables
        for a in range(tables.num_actions):
            ptn = tables.action_to_ptn(a)
            assert tables.ptn_to_action(ptn) == a
        for a in range(0, tables.num_actions, 97):
            ptn = tables.action_to_ptn(a)
            assert jtables.ptn_to_action(ptn) == a
    tables = get_engine(5).tables
    assert tables.ptn_to_action("1c3>1") == tables.ptn_to_action("c3>")
    assert tables.ptn_to_action("2c3>2") == tables.ptn_to_action("2c3>")
