"""InceptionV3 through the port's ``FFModel.fit`` against the JAX
package's, on the CPU (case and tolerances in ``_torch_zoo.py``)."""

from __future__ import annotations

import pytest

from _torch_zoo import check_fits_as_jax, zoo_setup  # noqa: F401  (autouse fixture)


@pytest.mark.parametrize("case", ["inception_v3"])
def test_zoo_model_fits_as_jax(case):
    check_fits_as_jax(case)
