"""Analysis of a placed step: per-device counts of the aten ops it
dispatches (``hlo_analyzer``) and the three-term roofline over them with
H100 constants (``roofline``). ``launch.dryrun`` records both for every
(arch x shape x mesh)."""
