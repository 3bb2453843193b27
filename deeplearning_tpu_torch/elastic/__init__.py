"""Elastic pieces the serving slice needs: fault injection and the
slow-vs-wedged detector."""
