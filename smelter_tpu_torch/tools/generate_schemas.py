"""Emit JSON-schema / OpenAPI artifacts from the port's wire API models
(`smelter_tpu_torch/api/schema.py`), the counterpart of the reference's
`tools/generate_schemas.py`: `scene.schema.json` and
`openapi_specification.json`, byte-equal to the reference's for the same
models.

Usage: python -m smelter_tpu_torch.tools.generate_schemas [outdir=generated/schemas]

The default directory is git-ignored; the committed `tools/schemas/` are
the reference's files and are never written here.
"""

import json
import os
import sys

import pydantic

from smelter_tpu_torch.api import schema as api

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_OUTDIR = os.path.join(REPO, "generated", "schemas")  # git-ignored


def main() -> None:
    outdir = sys.argv[1] if len(sys.argv) > 1 else DEFAULT_OUTDIR
    os.makedirs(outdir, exist_ok=True)

    scene_schema = pydantic.TypeAdapter(api.VideoScene).json_schema()
    with open(os.path.join(outdir, "scene.schema.json"), "w") as f:
        json.dump(scene_schema, f, indent=2, sort_keys=True)

    register_input = pydantic.TypeAdapter(api.RegisterInput).json_schema()
    register_output = pydantic.TypeAdapter(api.RegisterOutput).json_schema()
    update_output = pydantic.TypeAdapter(api.UpdateOutputRequest).json_schema()
    unregister = pydantic.TypeAdapter(api.UnregisterRequest).json_schema()
    unregister_body = {"content": {"application/json": {"schema": unregister}}}

    openapi = {
        "openapi": "3.0.3",
        "info": {"title": "smelter-tpu", "version": "0.1.0"},
        "paths": {
            "/api/input/{id}/register": {"post": {
                "operationId": "register_input",
                "requestBody": {"content": {"application/json": {
                    "schema": register_input}}},
                "responses": {"200": {"description": "registered"}},
            }},
            "/api/input/{id}/unregister": {"post": {
                "operationId": "unregister_input",
                "requestBody": unregister_body,
                "responses": {"200": {"description": "ok"}}}},
            "/api/input/{id}/update": {"post": {
                "operationId": "update_input",
                "requestBody": {"content": {"application/json": {"schema": {
                    "type": "object",
                    "properties": {"pause": {"type": "boolean"},
                                    "seek_ms": {"type": "number"}},
                    "additionalProperties": False}}}},
                "responses": {"200": {"description": "ok"}}}},
            "/api/output/{id}/register": {"post": {
                "operationId": "register_output",
                "requestBody": {"content": {"application/json": {
                    "schema": register_output}}},
                "responses": {"200": {"description": "registered"}}}},
            "/api/output/{id}/unregister": {"post": {
                "operationId": "unregister_output",
                "requestBody": unregister_body,
                "responses": {"200": {"description": "ok"}}}},
            "/api/output/{id}/update": {"post": {
                "operationId": "update_output",
                "requestBody": {"content": {"application/json": {
                    "schema": update_output}}},
                "responses": {"200": {"description": "ok"}}}},
            "/api/output/{id}/request_keyframe": {"post": {
                "operationId": "request_keyframe",
                "responses": {"200": {"description": "ok"}}}},
            "/api/shader/{id}/register": {"post": {
                "operationId": "register_shader",
                "responses": {"200": {"description": "ok"}}}},
            "/api/shader/{id}/unregister": {"post": {
                "operationId": "unregister_shader",
                "requestBody": unregister_body,
                "responses": {"200": {"description": "ok"}}}},
            "/api/image/{id}/register": {"post": {
                "operationId": "register_image",
                "responses": {"200": {"description": "ok"}}}},
            "/api/image/{id}/unregister": {"post": {
                "operationId": "unregister_image",
                "requestBody": unregister_body,
                "responses": {"200": {"description": "ok"}}}},
            "/api/web-renderer/{id}/register": {"post": {
                "operationId": "register_web_renderer",
                "responses": {"200": {"description": "ok"}}}},
            "/api/web-renderer/{id}/unregister": {"post": {
                "operationId": "unregister_web_renderer",
                "requestBody": unregister_body,
                "responses": {"200": {"description": "ok"}}}},
            "/api/font/register": {"post": {
                "operationId": "register_font",
                "responses": {"200": {"description": "ok"}}}},
            "/api/start": {"post": {"operationId": "start",
                "responses": {"200": {"description": "ok"}}}},
            "/api/reset": {"post": {"operationId": "reset",
                "responses": {"200": {"description": "ok"}}}},
            "/status": {"get": {"operationId": "status",
                "responses": {"200": {"description": "status"}}}},
            "/stats": {"get": {"operationId": "stats",
                "responses": {"200": {"description": "stats"}}}},
            "/whip/{id}": {"post": {"operationId": "whip_publish",
                "requestBody": {"content": {"application/sdp": {}}},
                "responses": {"201": {"description": "SDP answer"}}}},
            "/whep/{id}": {"post": {"operationId": "whep_subscribe",
                "requestBody": {"content": {"application/sdp": {}}},
                "responses": {"201": {"description": "SDP answer"}}}},
        },
    }
    with open(os.path.join(outdir, "openapi_specification.json"), "w") as f:
        json.dump(openapi, f, indent=2, sort_keys=True)
    print(f"wrote schemas to {outdir}")


if __name__ == "__main__":
    main()
