"""Serving: the slot-based batched engine of the payload LM (torch) and
the multi-tenant provisioning service (numpy control plane over any
policy).

Exports resolve lazily (PEP 562), so importing the provisioning service
never imports the model and decode path, and the reverse.
"""
_EXPORTS = {
    "Request": "engine",
    "ServeEngine": "engine",
    "CoSimChainLane": "cosim",
    "CoSimWorld": "cosim",
    "ProvisionService": "provision_service",
    "ServiceConfig": "provision_service",
    "ServiceHealth": "provision_service",
    "ServiceResult": "provision_service",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        import importlib
        mod = importlib.import_module(f".{_EXPORTS[name]}", __name__)
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(__all__))
