"""The integrity plane: for now the serving golden canary (``canary.py``).

The fingerprint vote, the shadow-step audit and quarantine of
``cxxnet_tpu/integrity/`` wait for the trainer-bound planes
(ROADMAP.md).
"""
