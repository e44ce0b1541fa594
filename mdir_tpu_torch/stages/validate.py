"""validate stage: load a frozen network, run its validations, return the
metrics -- ``mdir_tpu/stages/validate.py`` on the port. The metric dict
``{"eval": {key: value}}`` has the JAX package's keys, e.g.
``roxford5k/validation/score:ap_medium_avg.4``. In a process group (a
score's ``parallel: {data: N}``) every rank returns rank 0's metrics.
"""
import numpy as np

from ..learning import load_network
from ..learning.validation import initialize_validation
from ..parallel.mesh import from_rank0
from ..tools.events import initialize_processor


def validate(params, data, device="cuda"):
    """Run the scenario's validations on ``device`` (the card by default)."""
    np.random.seed(0)

    if params.keys() != {"network", "validation", "data"}:
        raise ValueError("validate takes network, validation and data, not "
                         "%s" % sorted(params))
    network = load_network(params["network"], device=device).eval()
    net_defaults = network.network_params.runtime.get("data", {})
    validation = initialize_validation(
        params["validation"], data=data, params_data=params["data"],
        default_criterion=None, net_defaults=net_defaults)

    events = initialize_processor(
        {"progress": {"print_each": 100,
                      "key_suffix": "validation/loss:total"}})
    for val, valtask in validation.validations(epoch=None):
        def logger(iteration, size, label, value, dtype, val=val):
            events.register_data(0, iteration, size,
                                 "%s/validation/%s" % (val, label), value,
                                 dtype)

        valtask.validate(network, logger)
    events.close_epoch()
    return (from_rank0({"eval": {key: values[0] for key, values
                                 in events.metadata.metadata().items()}}),)
