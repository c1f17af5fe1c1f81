# REINA serving image (reference deployment: Dockerfile +
# docker-compose.yml — gunicorn/Flask/Redis replaced by the stdlib
# HTTP server, threaded workers and the C++ shm result store).
FROM python:3.12-slim

RUN apt-get update && apt-get install -y --no-install-recommends \
        g++ make && rm -rf /var/lib/apt/lists/*

WORKDIR /app
COPY requirements.txt .
RUN pip install --no-cache-dir -r requirements.txt

COPY . .
# Build the native shared-memory result store and import the datasets
# (expects the upstream data mounted at /data at build time).
RUN make -C cpp
# RUN python -m reina_tpu.data.etl --source /data

ENV PORT=5000 REINA_CACHE=shm
EXPOSE 5000
CMD ["python", "-m", "reina_tpu.runtime.graphql.server"]
