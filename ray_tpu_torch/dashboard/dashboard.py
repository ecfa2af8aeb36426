"""Head-process dashboard: JSON state API + Prometheus metrics over HTTP.

The reference runs an aiohttp ``DashboardHead`` (``dashboard/head.py:69``)
with per-module routes (actor/node/job/metrics/state —
``dashboard/modules/*``) and a Prometheus exporter on the metrics agent
(``python/ray/_private/metrics_agent.py``).  This serves the same
surface from a stdlib ThreadingHTTPServer inside the head process:

- ``/``                    tiny HTML cluster summary
- ``/api/cluster_status``  resources, node/actor/task/object counts
- ``/api/nodes|actors|tasks|placement_groups|workers|objects``
- ``/api/jobs``            submitted jobs (job_submission)
- ``/metrics``             Prometheus text format (runtime + app metrics)
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

from ray_tpu_torch.util import metrics as metrics_mod


def _jsonable(obj):
    if isinstance(obj, bytes):
        return obj.hex()
    if isinstance(obj, dict):
        return {str(_jsonable(k)): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if hasattr(obj, "__dataclass_fields__"):
        return {k: _jsonable(getattr(obj, k)) for k in obj.__dataclass_fields__}
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    return repr(obj)


# Single-page web UI over the JSON API (the reference ships a 22k-LoC
# TypeScript frontend, dashboard/client/src; this is the build-step-free
# equivalent: live tables for every state table, auto-refreshing).
_INDEX = """<!doctype html><html><head><title>ray_tpu_torch dashboard</title>
<style>
 body{font-family:system-ui,sans-serif;margin:0;background:#f6f7f9;color:#1a1a2e}
 header{background:#1a1a2e;color:#fff;padding:10px 18px;display:flex;
        align-items:baseline;gap:16px}
 header h1{font-size:17px;margin:0} header span{opacity:.7;font-size:12px}
 nav{display:flex;gap:4px;padding:8px 14px;flex-wrap:wrap}
 nav button{border:1px solid #ccd;border-radius:6px;background:#fff;
            padding:5px 12px;cursor:pointer;font-size:13px}
 nav button.on{background:#1a1a2e;color:#fff;border-color:#1a1a2e}
 #cards{display:flex;gap:10px;padding:4px 14px;flex-wrap:wrap}
 .card{background:#fff;border:1px solid #e3e5ea;border-radius:8px;
       padding:8px 14px;min-width:110px}
 .card b{display:block;font-size:20px} .card small{color:#667}
 main{padding:8px 14px} table{border-collapse:collapse;width:100%;
      background:#fff;border:1px solid #e3e5ea;border-radius:8px;font-size:12px}
 th,td{padding:5px 9px;text-align:left;border-bottom:1px solid #eef0f4;
       max-width:340px;overflow:hidden;text-overflow:ellipsis;white-space:nowrap}
 th{background:#eef0f4;position:sticky;top:0} tr:hover td{background:#f3f6ff}
 .ALIVE,.RUNNING,.FINISHED,.true{color:#0a7d38}.DEAD,.FAILED,.false{color:#c0222b}
 #foot{color:#889;font-size:11px;padding:10px 14px}
 #detail{position:fixed;top:0;right:0;width:46%;height:100%;background:#fff;
   border-left:2px solid #1a1a2e;box-shadow:-4px 0 14px rgba(0,0,0,.15);
   overflow:auto;padding:14px;display:none;z-index:5}
 #detail pre{font-size:11px;white-space:pre-wrap;word-break:break-all}
 #detail .x{float:right;cursor:pointer;border:none;background:#eee;
   border-radius:5px;padding:3px 9px}
 #logview{background:#10131c;color:#cfd6e4;font-family:monospace;
   font-size:11px;padding:10px;border-radius:8px;white-space:pre-wrap;
   max-height:70vh;overflow:auto}
 tr.click{cursor:pointer}
 #flamegraph{position:relative;background:#fff;border:1px solid #e3e5ea;
   border-radius:8px;overflow:hidden;margin-bottom:10px}
 #flamegraph .frame{position:absolute;height:16px;line-height:16px;
   font-size:10px;font-family:monospace;overflow:hidden;white-space:nowrap;
   border-right:1px solid rgba(255,255,255,.55);box-sizing:border-box;
   padding-left:2px;cursor:default}
</style></head><body>
<header><h1>ray_tpu_torch</h1><span id="hdr"></span></header>
<div id="cards"></div>
<nav id="nav"></nav>
<main><table id="tbl"><thead></thead><tbody></tbody></table>
<div id="logpane" style="display:none"><div id="streams"></div>
<div id="logview"></div></div>
<div id="flamepane" style="display:none">
<div style="font-size:12px;color:#667;padding:4px 0">always-on profiler,
 trailing 10&nbsp;min, all origins merged &middot; hover a frame for counts
 &middot; <a href="/api/profile/continuous?window=600&amp;format=collapsed">
 folded stacks</a></div>
<div id="flamegraph"></div>
<table id="ftbl"><thead></thead><tbody></tbody></table></div></main>
<div id="detail"><button class="x" onclick="hideDetail()">close</button>
<h3 id="dtitle"></h3><pre id="dbody"></pre></div>
<div id="foot">auto-refresh 2s &middot; JSON API: /api/&lt;table&gt;[/&lt;id&gt;],
 /api/cluster_status, /api/serve/applications, /api/logs[/&lt;stream&gt;],
 <a href="/api/timeline">/api/timeline</a> (chrome://tracing),
 <a href="/api/events">/api/events</a> (flight recorder),
 <a href="/api/traces">/api/traces</a>[/&lt;id&gt;] (request traces),
 <a href="/api/metrics/list">/api/metrics/list</a>,
 /api/metrics/query?name=&amp;window=&amp;step=,
 <a href="/api/incidents">/api/incidents</a> (watchdog incidents),
 <a href="/api/slos">/api/slos</a> (declared SLOs + burn-rate),
 <a href="/api/memory">/api/memory</a> (ownership audit),
 <a href="/api/top">/api/top</a>,
 <a href="/api/perf">/api/perf</a> (step phases/MFU/compiles/HBM),
 /api/grafana_dashboard,
 /api/profile?duration=3[&amp;worker_id=][&amp;format=collapsed],
 /api/profile/continuous?window=300[&amp;origin=][&amp;diff_a=&amp;diff_b=],
 /metrics</div>
<script>
const TABS=["nodes","actors","tasks","workers","objects","placement_groups",
            "jobs","serve","events","traces","metrics","flame","logs",
            "incidents"];
const ID_FIELD={nodes:"node_id",actors:"actor_id",tasks:"task_id",
 workers:"worker_id",placement_groups:"pg_id",jobs:"job_id",
 traces:"trace_id"};
let tab="nodes",timer=null;
const nav=document.getElementById("nav");
TABS.forEach(t=>{const b=document.createElement("button");b.textContent=t;
 b.onclick=()=>{tab=t;hideDetail();render()};nav.appendChild(b);});
function cell(v){if(v===null)return"";if(typeof v==="object")
 return JSON.stringify(v);return String(v);}
function esc(v){return String(v).replace(/[&<>"']/g,c=>({"&":"&amp;","<":"&lt;",
 ">":"&gt;",'"':"&quot;","'":"&#39;"}[c]));}
function hideDetail(){document.getElementById("detail").style.display="none";}
async function showDetail(table,id){
 const r=await fetch(`/api/${table}/${encodeURIComponent(id)}`);
 if(!r.ok)return;
 const d=await r.json();
 document.getElementById("dtitle").textContent=`${table} ${id}`;
 let html=JSON.stringify(d,null,2);
 document.getElementById("dbody").textContent=html;
 const panel=document.getElementById("detail");
 panel.style.display="block";
 if(d.log_stream){
  const a=document.createElement("a");
  a.href=`/api/logs/${encodeURIComponent(d.log_stream)}`;
  a.textContent="view log: "+d.log_stream;a.target="_blank";
  document.getElementById("dtitle").appendChild(document.createElement("br"));
  document.getElementById("dtitle").appendChild(a);
 }
}
async function showLog(stream){
 const r=await fetch(`/api/logs/${encodeURIComponent(stream)}?tail=500`);
 document.getElementById("logview").textContent=
  r.ok?await r.text():"(stream unavailable)";
}
function spark(seriesList){
 // inline SVG sparkline: one polyline PER label series on shared scales
 // (concatenating per-worker series into one path renders a sawtooth
 // alternating between unrelated values, not a trend)
 const ns="http://www.w3.org/2000/svg";
 const svg=document.createElementNS(ns,"svg");
 svg.setAttribute("width","160");svg.setAttribute("height","28");
 const all=[];seriesList.forEach(s=>all.push(...s));
 if(all.length<2)return svg;
 const xs=all.map(p=>p[0]),ys=all.map(p=>p[1]);
 const x0=Math.min(...xs),x1=Math.max(...xs),
       y0=Math.min(...ys),y1=Math.max(...ys);
 const sx=x1>x0?156/(x1-x0):0,sy=y1>y0?24/(y1-y0):0;
 seriesList.slice(0,8).forEach((pts,si)=>{
  if(pts.length<2)return;
  const d=pts.map((p,i)=>(i?"L":"M")+(2+(p[0]-x0)*sx).toFixed(1)+","+
    (26-(p[1]-y0)*sy).toFixed(1)).join(" ");
  const path=document.createElementNS(ns,"path");
  path.setAttribute("d",d);path.setAttribute("fill","none");
  path.setAttribute("stroke",si?"#7a86b8":"#1a1a2e");
  path.setAttribute("stroke-width","1.2");
  svg.appendChild(path);
 });
 return svg;
}
async function renderMetrics(){
 // TSDB-backed trend view: one sparkline per retained metric
 document.getElementById("logpane").style.display="none";
 const tbl=document.getElementById("tbl");tbl.style.display="";
 const list=(await (await fetch("/api/metrics/list")).json()).slice(0,30);
 const qs=await Promise.all(list.map(m=>
  fetch(`/api/metrics/query?name=${encodeURIComponent(m.name)}`+
        "&window=1800&step=30").then(r=>r.json()).catch(()=>null)));
 const thead=document.querySelector("#tbl thead"),
       tbody=document.querySelector("#tbl tbody");
 thead.innerHTML="<tr><th>metric</th><th>type</th><th>series</th>"+
  "<th>last</th><th>trend (30m)</th></tr>";
 tbody.textContent="";
 list.forEach((m,i)=>{
  const q=qs[i];
  const seriesList=q?q.series.map(s=>s.points):[];
  // "last" is only meaningful for a single series; show the spread
  // across series otherwise
  let last="";
  const lasts=seriesList.filter(p=>p.length).map(p=>p[p.length-1][1]);
  if(lasts.length===1)last=String(lasts[0]);
  else if(lasts.length>1)
   last=`${Math.min(...lasts)}…${Math.max(...lasts)}`;
  const tr=document.createElement("tr");
  [m.name,m.type,String(m.num_series),last].forEach(t=>{
   const td=document.createElement("td");td.textContent=t;tr.appendChild(td);});
  const td=document.createElement("td");td.appendChild(spark(seriesList));
  tr.appendChild(td);tbody.appendChild(tr);
 });
 if(!list.length){thead.innerHTML="";
  tbody.innerHTML="<tr><td>(no series retained yet)</td></tr>";}
}
async function renderLogs(){
 document.getElementById("tbl").style.display="none";
 const pane=document.getElementById("logpane");pane.style.display="block";
 const streams=await (await fetch("/api/logs")).json();
 // built via createElement/textContent: a stream name (derived from a
 // user-chosen job_id) containing quotes/angle brackets must render as
 // text, never as markup or an onclick payload
 const box=document.getElementById("streams");box.textContent="";
 streams.forEach(s=>{
  const b=document.createElement("button");
  b.textContent=s.stream+" ";
  const sm=document.createElement("small");
  sm.textContent=`(${s.kind}, ${Math.round(s.bytes/1024)}K)`;
  b.appendChild(sm);
  b.onclick=()=>showLog(s.stream);
  box.appendChild(b);box.appendChild(document.createTextNode(" "));
 });
 if(!streams.length)box.textContent="(no log streams yet)";
}
function flameColor(s){let h=0;for(let i=0;i<s.length;i++)
 h=(h*31+s.charCodeAt(i))>>>0;
 return `hsl(${18+h%42},${55+h%30}%,${60+h%14}%)`;}
async function renderFlame(){
 // icicle flamegraph straight from the ProfileStore's folded stacks
 // (root at the top); every origin's history is already head-side, so
 // this costs one fetch — no sampling is triggered
 document.getElementById("tbl").style.display="none";
 document.getElementById("logpane").style.display="none";
 const pane=document.getElementById("flamepane");pane.style.display="block";
 const p=await (await fetch("/api/profile/continuous?window=600")).json();
 const root={n:0,kids:{}};
 for(const [stack,n] of Object.entries(p.folded||{})){
  root.n+=n;let cur=root;
  for(const f of stack.split("|"))
   {cur=cur.kids[f]??(cur.kids[f]={n:0,kids:{}});cur.n+=n;}}
 const g=document.getElementById("flamegraph");g.textContent="";
 let maxd=0;
 const place=(node,x0,x1,d)=>{
  maxd=Math.max(maxd,d);if(d>48)return;let x=x0;
  for(const [f,k] of Object.entries(node.kids).sort((a,b)=>b[1].n-a[1].n)){
   const w=(x1-x0)*k.n/node.n;
   if(w<0.15){x+=w;continue;}
   const el=document.createElement("div");
   el.className="frame";el.textContent=f;
   el.title=`${f}  ${k.n} samples (${(100*k.n/root.n).toFixed(1)}%)`;
   el.style.left=x+"%";el.style.width=w+"%";el.style.top=(d*17)+"px";
   el.style.background=flameColor(f);
   g.appendChild(el);
   place(k,x,x+w,d+1);x+=w;}};
 if(root.n)place(root,0,100,0);
 else g.textContent=" (no continuous-profile samples yet)";
 g.style.height=(Math.min(maxd+1,49)*17+4)+"px";
 const rows=p.stats||[];
 const thead=document.querySelector("#ftbl thead"),
       tbody=document.querySelector("#ftbl tbody");
 if(!rows.length){thead.innerHTML="";tbody.innerHTML=
  "<tr><td>(no origins reporting)</td></tr>";return;}
 const cols=Object.keys(rows[0]);
 thead.innerHTML="<tr>"+cols.map(c=>`<th>${esc(c)}</th>`).join("")+"</tr>";
 tbody.innerHTML=rows.map(r=>"<tr>"+cols.map(c=>
  `<td>${esc(cell(r[c]))}</td>`).join("")+"</tr>").join("");
}
async function render(){
 [...nav.children].forEach(b=>b.classList.toggle("on",b.textContent===tab));
 if(tab!=="flame")document.getElementById("flamepane").style.display="none";
 try{
  const s=await (await fetch("/api/cluster_status")).json();
  document.getElementById("hdr").textContent=
   Object.entries(s.cluster_resources).map(([n,r])=>
    n+": "+Object.entries(r).map(([k,v])=>k+"="+v).join(" ")).join(" | ");
  const cards=[["nodes",s.num_nodes],["actors",s.num_actors],
   ["tasks",s.num_tasks],["workers",s.num_workers],
   ["objects",s.object_store.num_objects??s.object_store.objects??"-"],
   ["store MB",Math.round((s.object_store.bytes_used??0)/1048576)]];
  document.getElementById("cards").innerHTML=cards.map(([k,v])=>
   `<div class=card><b>${v}</b><small>${k}</small></div>`).join("");
  if(tab==="logs"){await renderLogs();return;}
  if(tab==="metrics"){await renderMetrics();return;}
  if(tab==="flame"){await renderFlame();return;}
  document.getElementById("logpane").style.display="none";
  document.getElementById("tbl").style.display="";
  const url=tab==="serve"?"/api/serve/applications":"/api/"+tab+"?limit=200";
  let rows=await (await fetch(url)).json();
  if(!Array.isArray(rows)){rows=Object.entries(rows||{}).map(([k,v])=>
   Object.assign({name:k},typeof v==="object"?v:{value:v}));}
  const thead=document.querySelector("#tbl thead"),
        tbody=document.querySelector("#tbl tbody");
  if(!rows.length){thead.innerHTML="";tbody.innerHTML=
   "<tr><td>(empty)</td></tr>";return;}
  const cols=Object.keys(rows[0]);
  thead.innerHTML="<tr>"+cols.map(c=>`<th>${esc(c)}</th>`).join("")+"</tr>";
  const idf=ID_FIELD[tab];
  // every interpolated value is esc()'d: row ids (e.g. a user-chosen
  // job_id) and cell payloads must not be able to break out of the
  // attribute or inject elements
  tbody.innerHTML=rows.map(r=>{
   const id=idf?r[idf]:null;
   const attrs=id?` class=click data-id="${esc(id)}"`:"";
   return `<tr${attrs}>`+cols.map(c=>
    `<td class="${esc(cell(r[c]))}">${esc(cell(r[c]))}</td>`).join("")+"</tr>";
  }).join("");
  if(idf)[...tbody.querySelectorAll("tr.click")].forEach(tr=>
   tr.onclick=()=>showDetail(tab,tr.dataset.id));
 }catch(e){document.getElementById("hdr").textContent="error: "+e;}
}
render();timer=setInterval(render,2000);
</script></body></html>"""


class Dashboard:
    def __init__(self, node, host: str = "127.0.0.1", port: int = 0):
        self.node = node

        dash = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                try:
                    dash._route(self)
                except BrokenPipeError:
                    pass
                except Exception as e:
                    self.send_response(500)
                    self.end_headers()
                    self.wfile.write(str(e).encode())

            def do_PUT(self):
                try:
                    dash._route_put(self)
                except BrokenPipeError:
                    pass
                except Exception as e:
                    self.send_response(500)
                    self.end_headers()
                    self.wfile.write(str(e).encode())

            do_POST = do_PUT

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.address = self._server.server_address
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True, name="dashboard")
        self._thread.start()

    # -- routing -----------------------------------------------------------
    def _route(self, req: BaseHTTPRequestHandler) -> None:
        parsed = urlparse(req.path)
        path = parsed.path.rstrip("/")
        qs = parse_qs(parsed.query)
        limit = int(qs.get("limit", ["1000"])[0])
        if path == "":
            self._send(req, _INDEX, ctype="text/html")
            return
        if path == "/metrics":
            self._send(req, self._metrics_text(), ctype="text/plain; version=0.0.4")
            return
        if path == "/api/profile/continuous":
            # the always-on plane: merged history from the head's
            # ProfileStore (no new sampling — it is already there).
            # ?window=300[&origin=][&format=collapsed]; add
            # &diff_a=600&diff_b=60 for a differential profile
            store = self.node.profile_store
            origin = qs.get("origin", [None])[0]
            fmt = qs.get("format", ["json"])[0]
            if "diff_a" in qs or "diff_b" in qs:
                d = store.diff(
                    window_a=float(qs.get("diff_a", ["600"])[0]),
                    window_b=float(qs.get("diff_b", ["60"])[0]),
                    origin=origin)
                if fmt == "collapsed":
                    self._send(req, d["collapsed"],
                               ctype="text/plain; charset=utf-8")
                else:
                    self._send(req, json.dumps(_jsonable(d)))
                return
            window = float(qs.get("window", ["300"])[0])
            if fmt == "collapsed":
                self._send(req, store.collapsed(window, origin=origin),
                           ctype="text/plain; charset=utf-8")
                return
            prof = store.query(window, origin=origin)
            prof["stats"] = store.stats()
            self._send(req, json.dumps(_jsonable(prof)))
            return
        if path == "/api/profile":
            # on-demand sampling profile (py-spy/profile_manager.py analog):
            # ?duration=3 for the head; &worker_id=<hex> for a worker;
            # &format=collapsed for folded stacks (speedscope/flamegraph.pl)
            duration = min(30.0, float(qs.get("duration", ["3"])[0]))
            wid = qs.get("worker_id", [None])[0]
            fmt = qs.get("format", ["json"])[0]
            # collapsed consumers want the whole profile, not the top-40
            top = 10_000 if fmt == "collapsed" else 40
            result = self._profile(wid, duration, top)
            if fmt == "collapsed" and "report" in result:
                from ray_tpu_torch._private.sampling_profiler import (
                    collapsed_from_report,
                )

                self._send(req, collapsed_from_report(result["report"]),
                           ctype="text/plain; charset=utf-8")
                return
            self._send(req, json.dumps(result))
            return
        if path == "/api/metrics/list":
            # TSDB directory: every metric with retained history
            self._send(req, json.dumps(self.node.tsdb.list_metrics()))
            return
        if path == "/api/metrics/query":
            # time-series query over the head TSDB (the sparkline/Grafana
            # backend): ?name=...&window=3600&step=60[&agg=max]
            name = qs.get("name", [""])[0]
            if not name:
                req.send_response(400)
                req.end_headers()
                req.wfile.write(b'{"error": "name required"}')
                return
            try:
                result = self.node.tsdb.query(
                    name,
                    window_s=float(qs.get("window", ["3600"])[0]),
                    step_s=float(qs.get("step", ["0"])[0]),
                    agg=qs.get("agg", [None])[0],
                )
            except ValueError as e:
                req.send_response(400)
                req.end_headers()
                req.wfile.write(json.dumps({"error": str(e)}).encode())
                return
            self._send(req, json.dumps(result))
            return
        if path == "/api/memory":
            # object-ownership audit (`ray memory` analog over HTTP)
            self._send(req, json.dumps(_jsonable(
                self.node._memory_audit(limit=limit))))
            return
        if path == "/api/top":
            self._send(req, json.dumps(_jsonable(self.node._top_snapshot())))
            return
        if path == "/api/perf":
            # performance observability aggregate (`ray_tpu_torch perf` over
            # HTTP): step-phase breakdown, MFU trend, compile table,
            # HBM watermark, decode TTFT/ITL + prefill interference
            window = float(qs.get("window", ["1800"])[0])
            self._send(req, json.dumps(_jsonable(
                self.node._perf_summary(window_s=window))))
            return
        if path.startswith("/api/logs/"):
            # tail one log stream as plain text (reference log viewer:
            # dashboard/modules/log)
            tail = min(100_000, int(qs.get("tail", ["2000"])[0]))
            text = self._log_tail(path[len("/api/logs/"):], tail)
            if text is None:
                req.send_response(404)
                req.end_headers()
                return
            self._send(req, text, ctype="text/plain; charset=utf-8")
            return
        if path.startswith("/api/"):
            payload = self._api(path[len("/api/"):], limit)
            if payload is None:
                req.send_response(404)
                req.end_headers()
                return
            self._send(req, json.dumps(payload), ctype="application/json")
            return
        req.send_response(404)
        req.end_headers()

    @staticmethod
    def _send(req, body: str, ctype: str = "application/json") -> None:
        data = body.encode()
        req.send_response(200)
        req.send_header("Content-Type", ctype)
        req.send_header("Content-Length", str(len(data)))
        req.end_headers()
        req.wfile.write(data)

    def _profile(self, worker_id_hex, duration: float, top: int = 40):
        """Sample the head process, or ask a worker to sample itself."""
        import os as _os
        import threading as _threading

        if worker_id_hex is None:
            from ray_tpu_torch._private.sampling_profiler import profile_for

            return {"target": "head", "duration_s": duration,
                    "report": profile_for(duration, top=top)}
        node = self.node
        try:
            wid = bytes.fromhex(worker_id_hex)
        except ValueError:
            return {"error": f"bad worker_id {worker_id_hex!r}"}
        with node.lock:
            w = node.workers.get(wid)
        if w is None or w.conn is None or w.state == "dead":
            return {"error": "unknown or dead worker"}
        token = _os.urandom(8).hex()
        holder = {"event": _threading.Event(), "report": None}
        node._profile_acks[token] = holder
        try:
            w.send({"type": "profile", "token": token, "duration": duration,
                    "top": top})
        except (OSError, ValueError):
            node._profile_acks.pop(token, None)
            return {"error": "worker unreachable"}
        if not holder["event"].wait(duration + 30.0):
            node._profile_acks.pop(token, None)
            return {"error": "profile timed out"}
        return {"target": worker_id_hex, "duration_s": duration,
                "report": holder["report"]}

    # -- payloads ----------------------------------------------------------
    def _api(self, what: str, limit: int):
        node = self.node
        if what == "cluster_status":
            snap = node._state_snapshot()
            with node.lock:
                num_workers = len([w for w in node.workers.values()
                                   if w.state != "dead"])
            return _jsonable({
                "cluster_resources": snap["cluster_resources"],
                "available_resources": snap["available_resources"],
                "object_store": snap["object_store"],
                "num_nodes": len(snap["nodes"]),
                "num_actors": len(snap["actors"]),
                "num_tasks": len(snap["tasks"]),
                "num_workers": num_workers,
            })
        if what == "serve/applications":
            return self._serve_status()
        if what == "timeline":
            # chrome-trace of task events merged with streaming/collective/
            # serve spans from the flight recorder (``ray_tpu_torch timeline``
            # over HTTP; open in chrome://tracing / perfetto)
            from ray_tpu_torch.util.timeline import merged_timeline

            # _jsonable: recorder-event args may carry arbitrary app
            # payloads (numpy scalars) that plain json.dumps rejects
            return _jsonable(merged_timeline(
                node._list_state("tasks", 100_000),
                node._list_state("events", 100_000)))
        if what == "grafana_dashboard":
            # dashboard-as-code from the live registry (the reference's
            # metrics/grafana_dashboard_factory.py analog)
            from ray_tpu_torch.dashboard.grafana_dashboard_factory import (
                generate_grafana_dashboard,
            )

            return generate_grafana_dashboard(
                self._merged_snapshot(), tsdb=node.tsdb,
                slos=node.watchdog.slos() if node.watchdog else None)
        if what == "logs":
            return self._log_streams()
        if what == "serve/config":
            # the declarative goal config last applied over PUT (empty if
            # serve is down or nothing was config-deployed)
            import ray_tpu_torch
            from ray_tpu_torch.serve._private.controller import (
                CONTROLLER_NAME, SERVE_NAMESPACE)

            try:
                controller = ray_tpu_torch.get_actor(CONTROLLER_NAME,
                                               namespace=SERVE_NAMESPACE)
                return _jsonable(ray_tpu_torch.get(
                    controller.get_deploy_config.remote(), timeout=10) or {})
            except Exception:
                return {}
        if what.startswith("traces/"):
            # one assembled trace + critical-path analysis (the JSON the
            # `ray_tpu_torch trace <id>` CLI renders)
            trace = node._get_trace(what[len("traces/"):])
            if trace is None:
                return None
            from ray_tpu_torch.util.trace_analysis import analyze

            trace["analysis"] = analyze(trace)
            return _jsonable(trace)
        if "/" in what:
            # drill-down: /api/<table>/<id> -> full detail for one row
            # (after every named serve/... route — must not shadow them)
            table, _, key = what.partition("/")
            return self._detail(table, key)
        try:
            # the state-API backend takes the right locks and strips blobs
            rows = node._list_state(what, limit)
        except ValueError:
            return None
        if what == "nodes":
            self._merge_node_stats(rows)
        return _jsonable(rows)

    def _merge_node_stats(self, rows) -> None:
        """Attach each node's live utilization (agent pongs carry remote
        stats; head-local nodes read /proc here) plus resource load —
        the reference dashboard-agent's per-node metrics surface."""
        from ray_tpu_torch._private.resource_spec import host_stats

        node = self.node
        with node.lock:
            # only ALIVE nodes get stats: a dead remote's row must not
            # inherit the head host's /proc numbers (agent_conn is
            # cleared on death) or show stale pre-death stats as live
            live = {
                nid: (ns.host_stats, ns.utilization(),
                      ns.agent_conn is not None)
                for nid, ns in node.nodes.items() if ns.alive
            }
        local_stats = None
        for r in rows:
            nid = r.get("node_id")
            if nid not in live:
                continue
            stats, util, remote = live[nid]
            if stats is None and not remote:
                # emulated/head-local nodes genuinely share this host
                if local_stats is None:
                    local_stats = host_stats()
                stats = local_stats
            r["host_stats"] = stats
            r["resource_utilization"] = round(util, 3)

    # -- logs (reference dashboard/modules/log: per-worker files + job
    # driver logs under the session dir) -----------------------------------
    def _log_streams(self):
        import os

        node = self.node
        streams = []
        logs_dir = os.path.join(node.session_dir, "logs")
        try:
            for f in sorted(os.listdir(logs_dir)):
                if f.endswith(".log"):
                    full = os.path.join(logs_dir, f)
                    streams.append({
                        "stream": f[:-len(".log")], "kind": "worker",
                        "bytes": os.path.getsize(full),
                        "mtime": os.path.getmtime(full),
                    })
        except OSError:
            pass
        mgr = getattr(node, "job_manager", None)
        if mgr is not None:
            for info in mgr.list_jobs():
                lp = info.get("log_path")
                if lp and os.path.exists(lp):
                    streams.append({
                        "stream": f"job-{info['job_id']}", "kind": "job",
                        "bytes": os.path.getsize(lp),
                        "mtime": os.path.getmtime(lp),
                    })
        # union in the head LogStore's streams: remote-node workers have no
        # file under THIS session dir, but their shipped rings (and the
        # death tails of retired streams) are servable all the same
        store = getattr(node, "log_store", None)
        if store is not None:
            seen = {s["stream"] for s in streams}
            for r in store.stats():
                if r["stream"] in seen:
                    continue
                streams.append({
                    "stream": r["stream"],
                    "kind": "retired" if r.get("retired") else "remote",
                    "bytes": r["bytes"], "mtime": r.get("last_ts") or 0,
                })
        return streams

    def _log_path(self, stream: str):
        import os

        node = self.node
        if "/" in stream or ".." in stream:
            return None  # path traversal
        if stream.startswith("job-"):
            mgr = getattr(node, "job_manager", None)
            if mgr is not None:
                for info in mgr.list_jobs():
                    if f"job-{info['job_id']}" == stream:
                        return info.get("log_path")
            return None
        path = os.path.join(node.session_dir, "logs", f"{stream}.log")
        return path if os.path.exists(path) else None

    def _log_tail(self, stream: str, tail_lines: int):
        import os

        from ray_tpu_torch._private import log_plane

        path = self._log_path(stream)
        if path is None:
            # not a local file: serve from the head LogStore ring (a
            # remote node's worker, or a retired stream's death tail) —
            # cross-node logs in the same viewer, zero JS changes
            store = getattr(self.node, "log_store", None)
            if store is None or stream not in store:
                return None
            return "\n".join(store.tail_text(stream, n=tail_lines))
        try:
            size = os.path.getsize(path)
            with open(path, "rb") as f:
                # read at most ~200 bytes/line from the end, then trim
                f.seek(max(0, size - tail_lines * 200))
                data = f.read()
        except OSError:
            return None
        lines = data.decode("utf-8", "replace").splitlines()
        # strip the machine context stamps for human eyes
        return "\n".join(log_plane.parse_line(ln)[5]
                         for ln in lines[-tail_lines:])

    # -- drill-down --------------------------------------------------------
    def _detail(self, table: str, key: str):
        """Everything about one task/actor/node/worker/pg/job — the row's
        full record plus cross-references (its worker's log stream, an
        actor's pending/running tasks) for the reference's detail pages
        (dashboard/client src TaskDetail/ActorDetail)."""
        node = self.node
        try:
            rows = node._list_state(table, 100_000)
        except ValueError:
            return None
        id_fields = ("task_id", "actor_id", "node_id", "worker_id",
                     "pg_id", "group_id", "job_id", "oid", "object_id")
        match = None
        for r in rows:
            if any(str(r.get(f)) == key for f in id_fields if f in r):
                match = dict(r)
                break
        if match is None:
            return None
        if table == "tasks":
            wid = match.get("worker_id")
            if wid:
                match["log_stream"] = f"worker-{wid}"
        elif table == "actors":
            # the actor's tasks, newest first
            aid = match.get("actor_id")
            match["recent_tasks"] = [
                t for t in node._list_state("tasks", 100_000)
                if t.get("actor_id") == aid][-20:]
        elif table == "workers":
            match["log_stream"] = f"worker-{key}"
        return _jsonable(match)

    def _route_put(self, req: BaseHTTPRequestHandler) -> None:
        path = urlparse(req.path).path.rstrip("/")
        if path != "/api/serve/applications":
            req.send_response(404)
            req.end_headers()
            return
        length = int(req.headers.get("Content-Length") or 0)
        body = req.rfile.read(length) if length else b""
        code, payload = self._serve_deploy(body)
        data = json.dumps(payload).encode()
        req.send_response(code)
        req.send_header("Content-Type", "application/json")
        req.send_header("Content-Length", str(len(data)))
        req.end_headers()
        req.wfile.write(data)

    def _serve_deploy(self, body: bytes):
        """PUT /api/serve/applications: validate a declarative config and
        hand it to the controller to reconcile (the reference's
        ``dashboard/modules/serve/serve_head.py`` deploy path)."""
        import ray_tpu_torch
        from ray_tpu_torch.serve.schema import SchemaError, parse_deploy_config

        try:
            parsed = parse_deploy_config(json.loads(body or b"{}"))
        except (ValueError, SchemaError) as e:  # includes JSONDecodeError
            return 400, {"error": str(e)}
        try:
            from ray_tpu_torch.serve import api as serve_api

            serve_api.start()  # idempotent: connect-or-boot controller+proxy
            controller = serve_api._get_client().controller
        except Exception as e:  # noqa: BLE001
            return 503, {"error": f"cannot start serve: {type(e).__name__}: {e}"}
        try:
            out = ray_tpu_torch.get(
                controller.apply_deploy_config.remote(parsed.to_dict()),
                timeout=180)
        except Exception as e:  # noqa: BLE001
            return 500, {"error": f"deploy failed: {type(e).__name__}: {e}"}
        return 200, out

    def _serve_status(self):
        """Serve REST module (``dashboard/modules/serve`` analog): live
        deployment + autoscaling state pulled from the controller actor.
        No controller -> {}; a broken/slow controller -> explicit error
        payload (an operator must be able to tell the two apart)."""
        import ray_tpu_torch
        from ray_tpu_torch.serve._private.controller import (
            CONTROLLER_NAME, SERVE_NAMESPACE)

        try:
            controller = ray_tpu_torch.get_actor(CONTROLLER_NAME,
                                           namespace=SERVE_NAMESPACE)
        except Exception:
            return {}  # serve not running
        try:
            status = ray_tpu_torch.get(controller.get_status.remote(), timeout=10)
            # independent per-deployment calls: submit all, one shared get
            refs = {
                name: controller.get_autoscaling_metrics.remote(name)
                for name in status
            }
            metrics = ray_tpu_torch.get(list(refs.values()), timeout=10)
            for (name, _), m in zip(refs.items(), metrics):
                status[name]["autoscaling_metrics"] = m
            return _jsonable(status)
        except Exception as e:  # noqa: BLE001
            return {"error": f"serve controller unavailable: {type(e).__name__}: {e}"}

    def _merged_snapshot(self) -> dict:
        """Head registry + worker-reported metrics, with runtime gauges
        refreshed at scrape time (metric_defs.cc analog).  The gauge
        refresh lives on the Node so the TSDB sample loop and this scrape
        path can never disagree about what the runtime gauges mean; the
        merge itself is the Node's too (`_merged_metrics_snapshot` — one
        merge path for /metrics, perf_summary, and top)."""
        self.node.refresh_runtime_gauges()
        return self.node._merged_metrics_snapshot()

    def _metrics_text(self) -> str:
        return metrics_mod.prometheus_text(self._merged_snapshot())

    def close(self) -> None:
        try:
            self._server.shutdown()
            self._server.server_close()
        except Exception:
            pass
