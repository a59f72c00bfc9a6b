"""CPPN and SIREN layers -> shader source (GLSL / HLSL); the port's own
copy of aphantasia_tpu.shader_expo, which writes the same bytes.

Unrolls the trained layers into mat4/vec4 literal arithmetic with a
bufA/bufB ping-pong, for five targets: 'shadertoy', 'bookofshaders', 'td'
(TouchDesigner GLSL TOP), 'vvvv' (TextureFX .tfx) and 'buffer' (a
StructuredBuffer value dump), with time-animated inputs injected into
layer 3 and the float formatting at a chosen precision.  The hidden width
must be a multiple of 4 (vec4 packing).
"""
from __future__ import annotations

import numpy as np

MODES = {"shadertoy", "bookofshaders", "td", "vvvv", "buffer"}


class _Emitter:
    def __init__(self, hlsl: bool, precision: int, buffer_mode: bool):
        self.hlsl = hlsl
        self.fmt = "%%.%df" % precision
        self.buffer_mode = buffer_mode
        self.sb_values = []

    def vec(self, a) -> str:
        a = list(a) + [0.0] * (4 - len(a))
        if self.hlsl and self.buffer_mode:
            self.sb_values.extend(a)
            return "sbW[%d]" % (len(self.sb_values) // 4 - 1)
        kw = "float4" if self.hlsl else "vec4"
        return "%s(%s)" % (kw, ", ".join(self.fmt % x for x in a))

    def mat(self, m) -> str:
        m = np.asarray(m)
        if m.shape[0] < 4:
            m = np.vstack([m, np.zeros((4 - m.shape[0], m.shape[1]))])
        kw = "float4x4" if self.hlsl else "mat4"
        return "%s(%s)" % (kw, ", ".join(self.vec(row) for row in m))


def _layer_code(e: _Emitter, layers, mode: str) -> str:
    code = ""
    n = len(layers)
    for li, layer in enumerate(layers):
        weight = np.asarray(layer["weights"])          # [1,1,in,out]
        bias = np.asarray(layer["bias"])
        activation = layer["activation"]
        _, _, nin, nout = weight.shape
        code += "\n // layer %d \n" % li
        for to in range(max(1, nout // 4)):
            line = "bufA[%d] = %s" % (to, e.vec(bias[to * 4: to * 4 + 4]))
            for fr in range(max(1, nin // 4)):
                block = weight[0, 0, fr * 4: fr * 4 + 4, to * 4: to * 4 + 4]
                if e.hlsl:
                    line += " + mul(bufB[%d], %s)" % (fr, e.mat(block))
                else:
                    line += " + %s * bufB[%d]" % (e.mat(block), fr)
            # time-animated inputs injected into layer 3 (reference :155-160)
            if e.hlsl and 1 < li < n - 2:
                line += " + in%d_.%s" % (li, "xyzw"[to % 4])
            elif not e.hlsl and li == 3:
                line += " + in%d" % (to % 4)
            code += line + ";\n"
        if activation == "sigmoid" and nout != 3:
            raise ValueError(
                "sigmoid output head must emit 3 channels for shader "
                "export, got %d" % nout)
        if nout != 3 and activation != "sigmoid":
            half = nout // 4
            for to in range(half):
                if activation in ("comp", "unbias"):
                    code += "tmp = atan(bufA[%d]);\n" % to
                    code += "bufB[%d] = tmp/0.67;\n" % to
                    if activation == "comp":
                        code += "bufB[%d] = (tmp*tmp) / 0.6;\n" % (to + half)
                    else:
                        code += "bufB[%d] = (tmp*tmp - 0.45) / 0.396;\n" % (to + half)
                elif activation == "relu":
                    code += "bufB[%d] = (max(bufA[%d], 0.) - 0.4) / 0.58;\n" % (to, to)
                elif activation == "sine":
                    # SIREN layer; w0 is pre-folded into the exported weights
                    code += "bufB[%d] = sin(bufA[%d]);\n" % (to, to)
                else:
                    raise ValueError("unknown activation: %r" % activation)
        else:
            sig = "1. / (1. + exp(-bufA[0]))"
            if e.hlsl:
                code += "\n return float4((%s).rgb, 1.0);\n" % sig
            else:
                code += "\n return vec4((%s).xyz, 1.0);\n" % sig
    code += "}\n"
    return code


def cppn_to_shader(layers, fn_name: str = "cppn_fn", mode: str = "shadertoy",
                   verbose: bool = False, fix_aspect: bool = True,
                   size=(1.0, 1.0), precision: int = 8) -> str:
    """Layer dicts [{'weights': [1,1,in,out], 'bias': [out], 'activation'}]
    -> shader source (or the comma-joined value dump for mode='buffer')."""
    if mode not in MODES:
        raise ValueError(f"mode {mode} not one of {MODES}")
    n_hidden = np.asarray(layers[0]["weights"]).shape[-1]
    if n_hidden % 4 != 0:
        raise ValueError("hidden layer size must be a multiple of 4")

    hlsl = mode in ("vvvv", "buffer")
    e = _Emitter(hlsl, precision, buffer_mode=(mode == "buffer"))

    if hlsl:
        ins = ", ".join("in%d_" % i for i in range(2, len(layers) - 2))
        head = "\nfloat2 R:TARGETSIZE;\nfloat4 " + ins + ";"
        if mode == "buffer":
            head += "\nStructuredBuffer<float4> sbW;"
        head += (
            "\n#define mod(x,y) (x - y * floor(x/y))"
            "\n#define N_HIDDEN %d"
            "\nfloat4 %s(float2 uv) {"
            "\n    float4 bufA[N_HIDDEN/4];"
            "\n    float4 bufB[N_HIDDEN/2];"
            "\n    float4 tmp;"
            "\n    bufB[0] = float4(uv.x, uv.y, 0., 0.);\n"
            % (n_hidden, fn_name))
    else:
        if mode == "td":
            head = ("\nuniform float uIn0;\nuniform float uIn1;"
                    "\nuniform float uIn2;\nuniform float uIn3;"
                    "\nout vec4 fragColor;\n")
        elif mode == "bookofshaders":
            head = ("\n#ifdef GL_ES\nprecision lowp float;\n#endif"
                    "\nuniform vec2 u_resolution;\nuniform vec2 u_mouse;"
                    "\nuniform float u_time;\n")
        else:  # shadertoy
            head = "\n#ifdef GL_ES\nprecision lowp float;\n#endif\n"
        head += (
            "\n#define N_HIDDEN %d"
            "\nvec4 bufA[N_HIDDEN/4];"
            "\nvec4 bufB[N_HIDDEN/2];"
            "\nvec4 %s(vec2 coordinate, float in0, float in1, float in2, float in3) {"
            "\n    vec4 tmp;"
            "\n    bufB[0] = vec4(coordinate.x, coordinate.y, 0., 0.);\n"
            % (n_hidden, fn_name))

    body = _layer_code(e, layers, mode)
    tail = _harness(mode, fn_name, fix_aspect, size)

    if mode == "buffer":
        return ",".join(e.fmt % x for x in e.sb_values)
    return head + body + tail


def _harness(mode: str, fn_name: str, fix_aspect: bool, size) -> str:
    sy, sx = float(size[0]), float(size[1])
    if mode in ("vvvv", "buffer"):
        s = ("\nfloat4 PS(float4 p:SV_Position, float2 uv:TEXCOORD0): SV_Target {"
             "\n    uv = 2 * (uv - 0.5);\n")
        if fix_aspect:
            s += "\n    uv *= R/R.y;\n"
        s += ("\n    return %s(2*uv);\n}"
              "\ntechnique10 Process"
              "\n{\tpass P0 "
              "\n\t{ SetPixelShader(CompileShader(ps_4_0,PS())); }\n}\n"
              % fn_name)
        return s
    if mode == "td":
        s = "\nvoid main() {\n    vec2 uv = vUV.xy;\n"
        s += ("\n    uv.xy = vec2(1., -1.) * 2. * (uv.xy - vec2(0.5, 0.5));"
              "\n    uv.y /= %s / %s;"
              "\n    fragColor = TDOutputSwizzle(%s(uv.xy, uIn0, uIn1, uIn2, uIn3));\n}\n"
              % (sy, sx, fn_name))
        return s
    if mode == "shadertoy":
        s = ("\nvoid mainImage( out vec4 fragColor, in vec2 fragCoord ) {"
             "\n    vec2 uv = fragCoord/iResolution.xy;\n")
        if fix_aspect:
            s += ("\n    uv.x *= iResolution.x / iResolution.y;"
                  "\n    uv.x -= ((iResolution.x / iResolution.y) - 1.) /2.;\n")
        s += ("\n    uv = vec2(1., -1.) * 1.5 * (uv - vec2(0.5, 0.5));"
              "\n    uv.y /= %s / %s;"
              "\n    fragColor = %s(uv, 0.23*sin(iTime), 0.32*sin(0.69*iTime), "
              "0.32*sin(0.44*iTime), 0.23*sin(1.23*iTime));\n}\n"
              % (sy, sx, fn_name))
        return s
    # bookofshaders
    s = "\nvoid main() {\n    vec2 st = gl_FragCoord.xy/u_resolution.xy;\n"
    if fix_aspect:
        s += ("\n    st.x *= u_resolution.x/u_resolution.y;"
              "\n    st.x -= ((u_resolution.x / u_resolution.y) - 1.) /2.;\n")
    s += ("\n    st = vec2(1., -1.) * 1.5 * (st - vec2(0.5, 0.5));"
          "\n    st.y /= %s / %s;"
          "\n    gl_FragColor = %s(st, 0.23*sin(u_time), 0.32*sin(0.69*u_time), "
          "0.32*sin(0.44*u_time), 0.23*sin(1.23*u_time));\n}\n"
          % (sy, sx, fn_name))
    return s


def export_gfx(layers, out_name: str, mode: str, precision: int, size) -> str:
    """Write one shader target to disk (reference cppn.py:141-148)."""
    shader = cppn_to_shader(layers, mode=mode, fix_aspect=True, size=size,
                            precision=precision)
    if mode == "vvvv":
        out_path = out_name + ".tfx"
    elif mode == "buffer":
        out_path = out_name + ".txt"
    else:
        out_path = out_name + "-%s.glsl" % mode
    with open(out_path, "wt") as f:
        f.write(shader)
    return out_path


def export_all(layers, out_name: str, size, precision: int = 3):
    """All five targets (reference cppn.py:164-168)."""
    return [export_gfx(layers, out_name, m, precision, size)
            for m in ("td", "vvvv", "buffer", "bookofshaders", "shadertoy")]
