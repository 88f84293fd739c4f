"""The distributed layer: the ambient mesh (``context.py``), the sharding
rules and placement (``sharding.py``), int8 compressed means
(``compression.py``) and the train, prefill and decode steps
(``steps.py``)."""
