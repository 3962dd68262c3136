# rad-tpu index server image (deploy parity with the reference's
# Dockerfile, which serves the public rad.docking.org-style HNSW service).
# The index (.npz) and SMILES SQLite are mounted at runtime.
FROM python:3.12-slim

RUN apt-get update && apt-get install -y --no-install-recommends g++ \
    && rm -rf /var/lib/apt/lists/*

WORKDIR /app
COPY setup.py README.md ./
COPY rad_tpu ./rad_tpu
COPY scripts ./scripts
RUN pip install --no-cache-dir "jax[cpu]" && pip install --no-cache-dir -e .

EXPOSE 8000
# mount: -v /data/library.rad.npz:/data/index.npz -v /data/smiles.db:/data/smiles.db
CMD ["python", "scripts/start_hnsw_server.py", \
     "--hnsw-path", "/data/index.npz", \
     "--database-path", "/data/smiles.db", \
     "--host", "0.0.0.0", "--port", "8000"]
