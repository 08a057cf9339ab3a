"""The general runners, one a traffic kind. Each has ``setup``,
``window``, ``trace_context``, ``release``, ``check`` and ``control``."""
