# Convenience targets mirroring the reference's Makefile interface
# (reference: Makefile:18-28 — `make run-<dataset>` with tuned parameters).
# No build step: the framework is JAX; the optional native loader builds
# itself on first use (csrc/loader.cpp via ctypes).

PY ?= python

.PHONY: test run-cora run-citeseer run-pubmed run-reddit run-products \
        run-cora-gat run-citeseer-gat run-reddit-gat-coo bench perf accuracy \
        tuning layout golden scaling smoke kernels mesh-onechip native clean

test:
	$(PY) -m pytest tests/ -x -q

run-cora:
	$(PY) -m parallel_gcn cora

run-citeseer:
	$(PY) -m parallel_gcn citeseer

# pubmed/reddit feature blobs are not shipped; these run the stand-ins
# (synth-pubmed = real graph + synthetic features; synth-reddit = generated)
run-pubmed:
	$(PY) -m parallel_gcn synth-pubmed

run-reddit:
	$(PY) -m parallel_gcn synth-reddit

# beyond-reference scale (ogbn-products scale, 2.45M nodes / 124M edges)
run-products:
	$(PY) -m parallel_gcn synth-products

# beyond-reference model family: GAT (models/gat.py, arXiv:1710.10903) on the
# same data layer + trainer; paper-style config (8 heads x 8 per-head dims)
GAT_ARGS = model=gat heads=8 hidden_dims=8 dropouts=0.6,0.6 attn_dropout=0.6 \
           learning_rate=0.005 epochs=300 early_stopping=30
run-cora-gat:
	$(PY) -m parallel_gcn cora $(GAT_ARGS)
run-citeseer-gat:
	$(PY) -m parallel_gcn citeseer $(GAT_ARGS) compute_dtype=float32
# attention at reddit scale: the COO route with remat + streaming chunked
# edge softmax (GAT has no tile route)
run-reddit-gat-coo:
	$(PY) -m parallel_gcn synth-reddit model=gat heads=2 hidden_dims=32 \
	  dropouts=0.0,0.1 epochs=100 early_stopping=0 mode=eager \
	  backend=segment reorder=none remat=true edge_chunk=1048576 \
	  compute_dtype=bfloat16

bench:
	$(PY) bench.py

# the mesh path on one GPU: 1-device mesh, fused runs, sharding tax vs
# plain fit (GCN hybrid slabs + GAT over the COO partition)
mesh-onechip:
	$(PY) harness/mesh_onechip.py

perf:
	$(PY) harness/performance.py

accuracy:
	$(PY) harness/accuracy.py

tuning:
	$(PY) harness/tuning.py cora --preset fine

layout:
	$(PY) harness/tuning_layout.py synth-pubmed

golden:
	$(PY) harness/performance_golden.py

scaling:
	$(PY) harness/scaling.py synth-medium --devices 1,2,4

smoke:
	$(PY) chip_smoke.py

kernels:
	$(PY) harness/kernel_bench.py

native:
	$(MAKE) -C csrc

clean:
	rm -rf output .pytest_cache parallel_gcn/data/_native*.so
	find . -name __pycache__ -type d -exec rm -rf {} +
