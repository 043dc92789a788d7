"""The model registry and the eps / score wrappers (counterpart of
``gddim_tpu/models/__init__.py``). The registry imports the model modules
when a name is first looked up; ``init_model`` is the port's
(``run_lib.init_model``: config, device, weights); ``place_model`` places a
model over a process group's ranks (``parallel.mesh.place_model``)."""

from gddim_torch.models.registry import available_models, get_model, register_model
from gddim_torch.models.wrappers import (
    make_blur_eps_fn,
    make_blur_yeps_fn,
    make_cld_eps_fn,
    make_cld_score_fn,
    stack_uv_to_channels,
    unstack_channels_to_uv,
)


def init_model(config, device="cuda", weights: str | None = None):
    """The configured model (``run_lib.init_model``)."""
    from gddim_torch.run_lib import init_model as _init_model

    return _init_model(config, device, weights)



def __getattr__(name):
    """``place_model`` loads ``parallel.mesh`` on first use."""
    if name == "place_model":
        from gddim_torch.parallel.mesh import place_model

        return place_model
    raise AttributeError(name)
