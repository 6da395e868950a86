"""Annotation tooling of the port (``prepare_annotations``, ``coco``),
copied from ``satnerf_tpu/data_prep``: the class map and colours the
semantic visualizers read. The rest of dataset construction is not ported
yet."""
