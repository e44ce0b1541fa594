"""Deep scenario-dict overlay, as ``mdir_tpu/config/overlay.py`` (reference
``daan/core/experiments.py:15-38``): later dicts merge into earlier ones
recursively; a key ending in ``*`` replaces the subtree, a key ending in
``+`` appends to a list, integer keys index into lists, and merging two
lists implicitly is an error. ``yaml`` is imported inside ``load_scenario``,
the one function that reads files.
"""


def _overlay_item(original, key, item):
    if isinstance(key, str) and key.endswith("*"):
        original[key[:-1]] = item
    elif isinstance(key, str) and key.endswith("+"):
        if key[:-1] not in original:
            raise ValueError(
                "'%s' appends to a key the base scenario never defined "
                "('%s' is missing: define it in an earlier file or drop "
                "the '+')" % (key, key[:-1]))
        original[key[:-1]] += item
    elif key not in original:
        original[key] = item
    else:
        original[key] = dict_deep_overlay(original[key], item)


def dict_deep_overlay(*data, list_replace=False):
    """Recursively overlay dictionaries, later arguments win."""
    if len(data) == 1:
        return data[0]
    if len(data) > 2:
        head = dict_deep_overlay(data[0], data[1], list_replace=list_replace)
        return dict_deep_overlay(head, *data[2:], list_replace=list_replace)

    original, overlay = data
    if isinstance(original, (list, tuple)) and isinstance(overlay, dict):
        for key, item in overlay.items():
            if not isinstance(key, int):
                raise ValueError("a list overlay takes int keys, got %r"
                                 % (key,))
            original[key] = dict_deep_overlay(original[key], item)
        return original
    if not isinstance(original, type(overlay)):
        return overlay
    if isinstance(overlay, dict):
        for key, item in overlay.items():
            _overlay_item(original, key, item)
        return original
    if isinstance(overlay, list) and not list_replace:
        raise ValueError(
            "Cannot implicitly merge two lists, use key* or key+ when "
            "inheriting: (list1: %s, list2: %s)" % (original, overlay))
    return overlay


def load_scenario(paths):
    """Overlay a sequence of yaml scenario files into one dict. An empty
    file is a no-op overlay."""
    scenario = {}
    for path in paths:
        import yaml

        with open(path, "r") as handle:
            loaded = yaml.safe_load(handle)
        if loaded is not None:
            scenario = dict_deep_overlay(scenario, loaded)
    return scenario
