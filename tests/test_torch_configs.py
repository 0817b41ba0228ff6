"""The port's config registry held against the JAX package's."""
import dataclasses

import pytest

from _torch_configs import reference_fields
from repro import configs as jconfigs
from repro_torch import configs as tconfigs


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_all_configs_equal_reference(arch):
    """``all_configs()`` holds every architecture's FULL config, each equal
    to the reference's ``all_configs()`` entry field by field, the port's
    own options at their defaults (``_torch_configs``)."""
    port, reference = tconfigs.all_configs(), jconfigs.all_configs()
    assert port.keys() == reference.keys() == set(jconfigs.ARCH_IDS)
    assert list(port) == tconfigs.ARCH_IDS
    assert reference_fields(port[arch], reference[arch]) == \
        dataclasses.asdict(reference[arch])
    assert port[arch] == tconfigs.get_config(arch)
