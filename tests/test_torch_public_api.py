"""Every public name of dedalus_tpu.public (no leading underscore, not a
module) is on dedalus_tpu_torch.public, except the names that wait for a
module of the port (public.PENDING_NAMES, each with its ROADMAP key)."""

import types

import dedalus_tpu.public as jd3
import dedalus_tpu_torch.public as td3


def _public_names(mod):
    return {n for n in dir(mod)
            if not n.startswith('_') and not isinstance(getattr(mod, n), types.ModuleType)}


def test_port_public_has_every_reference_name():
    missing = _public_names(jd3) - _public_names(td3) - set(td3.PENDING_NAMES)
    assert not missing, sorted(missing)


def test_pending_names_are_pending():
    assert set(td3.PENDING_NAMES) == {'DirectProduct', 'quick_domains'}
    for name, key in td3.PENDING_NAMES.items():
        assert not hasattr(td3, name)
        assert key.startswith('M')
