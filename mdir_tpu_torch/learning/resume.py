"""Resume consistency, as ``mdir_tpu/learning/resume.py``: a session may
continue from a checkpoint only under the scenario that wrote it, except
that the total epoch count may change (reference
``mdir/learning/training.py:91-97``, ``mdir/learning/learning.py:46-50``).
"""


def require(condition, what, stored, requested):
    """Uniform resume-mismatch error with both sides in the message."""
    if not condition:
        raise AssertionError("resume %s mismatch: %s != %s"
                             % (what, stored, requested))


def merge_epoch_override(stored_params, requested_params):
    """The stored training params with the requested epoch count; every
    other key must match."""
    if requested_params is None:
        return stored_params
    drop = lambda d: {k: v for k, v in d.items() if k != "epochs"}
    require(drop(stored_params) == drop(requested_params),
            "training params", drop(stored_params), drop(requested_params))
    merged = dict(stored_params)
    merged["epochs"] = requested_params["epochs"]
    return merged


def check_session_consistency(train_stats, scenario_params):
    """A resumed session must have the checkpoint's validation and data
    sections."""
    require(train_stats["validation"]["params"]
            == scenario_params["learning"]["validation"],
            "validation params", train_stats["validation"]["params"],
            scenario_params["learning"]["validation"])
    require(train_stats["datasets"] == scenario_params["data"],
            "dataset params", train_stats["datasets"],
            scenario_params["data"])
