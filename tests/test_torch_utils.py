"""The port's copies of the numpy utils (vector_db_torch/utils/
vector_utils.py, text_vectorizer.py) against the reference's, and the
port's text-search example (vector_db_torch/examples/
text_search_example.py) end to end at a tiny size on the CPU."""

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from vector_db_tpu.utils import text_vectorizer as ref_tv  # noqa: E402
from vector_db_tpu.utils import vector_utils as ref_vu  # noqa: E402
from vector_db_torch.examples import text_search_example  # noqa: E402
from vector_db_torch.utils import text_vectorizer as tv  # noqa: E402
from vector_db_torch.utils import vector_utils as vu  # noqa: E402


@pytest.mark.parametrize("fn", ["euclidean_distance",
                                "squared_euclidean_distance",
                                "cosine_similarity"])
def test_pair_functions_equal_the_references(fn, rng):
    a, b = rng.standard_normal((2, 37)).astype(np.float32)
    assert getattr(vu, fn)(a, b) == getattr(ref_vu, fn)(a, b)
    assert vu.cosine_similarity(np.zeros(3), np.ones(3)) == 0.0
    with pytest.raises(ValueError):
        getattr(vu, fn)(a, b[:5])


def test_norm_normalize_and_quantize_equal_the_references(rng):
    v = rng.standard_normal(50).astype(np.float32)
    assert vu.norm(v) == ref_vu.norm(v)
    np.testing.assert_array_equal(vu.normalize(v), ref_vu.normalize(v))
    np.testing.assert_array_equal(vu.normalize(np.zeros(4)),
                                  ref_vu.normalize(np.zeros(4)))
    q, lo, scale = vu.quantize(v)
    rq, rlo, rscale = ref_vu.quantize(v)
    np.testing.assert_array_equal(q, rq)
    assert (lo, scale) == (rlo, rscale)
    np.testing.assert_array_equal(vu.dequantize(q, lo, scale),
                                  ref_vu.dequantize(rq, rlo, rscale))


@pytest.mark.parametrize("text", ["a", "vector databases", "naïve café"])
def test_text_vectors_equal_the_references(text):
    got = tv.text_to_vector(text, 96)
    np.testing.assert_array_equal(got, ref_tv.text_to_vector(text, 96))
    np.testing.assert_array_equal(
        tv.generate_similar_vector(got, 0.2, seed=3),
        ref_tv.generate_similar_vector(got, 0.2, seed=3))
    assert tv.cosine_similarity(got, got) == pytest.approx(1.0)
    with pytest.raises(ValueError):
        tv.text_to_vector("", 8)


def test_example_runs_all_seven_types_on_the_cpu(capsys):
    rows = text_search_example.main(["--dim", "48", "--n", "300",
                                     "--queries", "16", "--device", "cpu"])
    assert [r["index"] for r in rows] == [t.value for t in
                                          text_search_example.TYPES]
    assert len(rows) == 7
    assert rows[0]["index"] == "brute" and rows[0]["top5"] >= 0.9
    for r in rows:  # the approximate types (LSH the loosest at 48 dims)
        assert r["top5"] >= 0.5, r
    assert "query: noisy variant of" in capsys.readouterr().out
