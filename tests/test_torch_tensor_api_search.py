"""The port's search and stat functions against the reference's
(``paddle_tpu/tensor/{search,stat}.py``), one parametrised case per public
function (values, dtypes and gradients; ``tests/torch_tensor_api_common.py``),
and the orders the reference's JAX gives that torch does not promise."""
import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu_torch as port
from torch_tensor_api_common import SKIP_VALUE, port_on_cpu, reference_names, run_case  # noqa: F401


@pytest.mark.parametrize("name", reference_names("search") + reference_names("stat"))
def test_search_and_stat_function_matches_paddle_tpu(name):
    assert name not in SKIP_VALUE
    run_case(name)


def test_median_of_an_even_count_averages_the_middle_pair():
    x = np.array([[4.0, 1.0, 3.0, 2.0]], np.float32)
    got = port.median(torch.from_numpy(x), axis=1)
    assert float(got) == 2.5 == float(np.asarray(ref.median(ref.to_tensor(x), axis=1)._value))
    assert float(torch.median(torch.from_numpy(x), dim=1).values) == 2.0  # torch's lower one


def test_ties_sort_stably_and_topk_takes_the_lowest_index_first():
    x = np.array([[1.0, 3.0, 3.0, 0.0, 3.0]], np.float32)
    vals, idx = port.topk(torch.from_numpy(x), 2, axis=1)
    assert idx.tolist() == [[1, 2]] and vals.tolist() == [[3.0, 3.0]]
    assert port.argsort(torch.from_numpy(x), axis=1, descending=True).tolist() == [[1, 2, 4, 0, 3]]
    _, ridx = ref.topk(ref.to_tensor(x), 2, axis=1)
    assert np.asarray(ridx._value).tolist() == [[1, 2]]


def test_quantile_has_no_size_limit():
    x = torch.zeros(17 * 1024 * 1024)
    x[-1] = 1.0
    assert float(port.quantile(x, 1.0)) == 1.0 and float(port.median(x)) == 0.0
