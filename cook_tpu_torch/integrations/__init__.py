"""Framework integrations: Dask cluster backend, Spark design notes.

The reference ships a design doc for Dask (dask/docs/design.md — doc
only, no code) and Spark scheduler-backend patches (spark/). Here the
Dask backend is implemented for real (integrations/dask_cook.py) with
an import-gated dependency on `distributed`, and the Spark integration
is documented (docs/spark.md) since the reference's patches target
long-EOL Spark 1.5/1.6.
"""
