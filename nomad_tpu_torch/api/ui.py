"""Web UI (reference: ui/ — the reference ships a full Ember SPA; this is
a dependency-free single-file SPA over the same /v1 API).  Served at
`/ui`.

Views (hash-routed):
  #/                overview: jobs, cluster topology (nodes per DC,
                    colored by status/utilization), deployments,
                    services, live event stream
  #/job/<ns>/<id>   job drill-down: definition summary, allocations,
                    evaluations, versions
  #/alloc/<id>      allocation drill-down: task states + event timeline
  #/node/<id>       node drill-down: attributes, running allocations
A region selector (federation table) retargets every API call.

Difference from the reference (nomad_tpu/api/ui.py): one comment of the
page's script drops a note on the reference's own history.
"""

UI_HTML = """<!doctype html>
<html lang="en">
<head>
<meta charset="utf-8">
<title>nomad-tpu</title>
<style>
  :root { color-scheme: light dark; }
  body { font: 14px/1.45 system-ui, sans-serif; margin: 0;
         background: Canvas; color: CanvasText; }
  header { padding: .7rem 1.2rem; border-bottom: 1px solid
           color-mix(in srgb, CanvasText 18%, Canvas);
           display: flex; gap: 1rem; align-items: baseline; }
  header h1 { font-size: 1.05rem; margin: 0; }
  header h1 a { color: inherit; text-decoration: none; }
  header span { opacity: .65; font-size: .85rem; }
  header select { margin-left: auto; font: inherit; }
  main { display: grid; grid-template-columns: 1fr 1fr; gap: 1rem;
         padding: 1rem 1.2rem; max-width: 1280px; }
  section { border: 1px solid color-mix(in srgb, CanvasText 14%, Canvas);
            border-radius: 8px; padding: .6rem .9rem; overflow: auto; }
  section.wide { grid-column: 1 / -1; }
  h2 { font-size: .82rem; text-transform: uppercase; letter-spacing: .06em;
       opacity: .7; margin: .2rem 0 .6rem; }
  table { border-collapse: collapse; width: 100%; font-size: .85rem; }
  td, th { text-align: left; padding: .18rem .6rem .18rem 0;
           white-space: nowrap; }
  th { opacity: .6; font-weight: 600; }
  .ok   { color: #2e9e57; } .warn { color: #c7831c; }
  .bad  { color: #cc4125; } .dim  { opacity: .55; }
  a { color: inherit; }
  #events { font-family: ui-monospace, monospace; font-size: .78rem;
            max-height: 14rem; }
  code { font-family: ui-monospace, monospace; font-size: .92em; }
  .topo { display: flex; flex-wrap: wrap; gap: .9rem; }
  .dc { border: 1px dashed color-mix(in srgb, CanvasText 25%, Canvas);
        border-radius: 6px; padding: .4rem .6rem; }
  .dc h3 { margin: 0 0 .3rem; font-size: .75rem; opacity: .7; }
  .cells { display: grid; grid-template-columns: repeat(10, 14px);
           gap: 3px; }
  .cell { width: 14px; height: 14px; border-radius: 3px; cursor: pointer;
          background: #2e9e57; }
  .cell.mid { background: #c7831c; } .cell.hot { background: #e06c30; }
  .cell.down { background: #cc4125; } .cell.inelig { background: #888; }
  .bar { height: 6px; border-radius: 3px; background:
         color-mix(in srgb, CanvasText 15%, Canvas); position: relative; }
  .bar i { position: absolute; inset: 0 auto 0 0; border-radius: 3px;
           background: #2e9e57; }
  #term { font-family: ui-monospace, monospace; font-size: .82rem;
          background: color-mix(in srgb, CanvasText 92%, Canvas);
          color: color-mix(in srgb, Canvas 92%, CanvasText);
          border-radius: 6px; padding: .6rem; min-height: 16rem;
          max-height: 28rem; overflow-y: auto; white-space: pre-wrap; }
  #termcmd { width: 60%; font-family: ui-monospace, monospace; }
  .diff-add { color: #2e9e57; } .diff-del { color: #cc4125; }
  .diff { font-family: ui-monospace, monospace; font-size: .82rem;
          white-space: pre-wrap; }
</style>
</head>
<body>
<header>
  <h1><a href="#/">nomad-tpu</a></h1>
  <span id="meta">connecting…</span>
  <select id="region" title="region"></select>
</header>
<main id="main"></main>
<script>
const cls = s => ({running:'ok', ready:'ok', successful:'ok', complete:'ok',
                   passing:'ok', healthy:'ok',
                   pending:'warn', paused:'warn', blocked:'warn',
                   failed:'bad', down:'bad', critical:'bad', lost:'bad',
                   dead:'dim', canceled:'dim'}[s] || '');
const cell = (v, c) => `<td class="${c||''}">${v ?? ''}</td>`;
const row = cells => `<tr>${cells.join('')}</tr>`;
const code = s => `<code>${s}</code>`;
const esc = s => String(s).replace(/[&<>"]/g,
  ch => ({'&':'&amp;','<':'&lt;','>':'&gt;','"':'&quot;'}[ch]));
let REGION = '';

async function get(path) {
  const sep = path.includes('?') ? '&' : '?';
  const r = await fetch(REGION ? `${path}${sep}region=` +
    encodeURIComponent(REGION) : path);
  if (!r.ok) throw new Error(`${r.status} ${path}`);
  return r.json();
}
async function post(path, body) {
  const sep = path.includes('?') ? '&' : '?';
  const r = await fetch(REGION ? `${path}${sep}region=` +
    encodeURIComponent(REGION) : path,
    {method: 'POST', headers: {'Content-Type': 'application/json'},
     body: JSON.stringify(body)});
  const data = await r.json().catch(() => null);
  if (!r.ok) throw new Error((data && (data.Error || data.error))
                             || `${r.status} ${path}`);
  return data;
}
const sect = (title, body, wide) =>
  `<section${wide ? ' class="wide"' : ''}><h2>${title}</h2>${body}</section>`;
const table = (heads, rows) =>
  `<table>${row(heads.map(h => `<th>${h}</th>`))}${rows.join('')}</table>`;

// ------------------------------------------------------------- overview
async function viewOverview() {
  const [jobs, nodes, allocs, deps, svcs, metrics] = await Promise.all([
    get('/v1/jobs?namespace=*'), get('/v1/nodes'),
    get('/v1/allocations?namespace=*'),
    get('/v1/deployments?namespace=*'), get('/v1/services?namespace=*'),
    get('/v1/metrics')]);
  document.getElementById('meta').textContent =
    `${metrics['nomad.state.jobs']} jobs · ` +
    `${metrics['nomad.state.nodes']} nodes · ` +
    `broker ready ${metrics['nomad.broker.total_ready']} · ` +
    `blocked ${metrics['nomad.blocked_evals.total_blocked']}`;

  // per-node live alloc counts for the topology heat
  const byNode = {};
  for (const a of allocs)
    if (a.ClientStatus === 'running' || a.ClientStatus === 'pending')
      byNode[a.NodeID] = (byNode[a.NodeID] || 0) + 1;
  const dcs = {};
  for (const n of nodes) (dcs[n.Datacenter] ||= []).push(n);
  const topo = Object.keys(dcs).sort().map(dc => {
    const cells = dcs[dc].map(n => {
      const k = byNode[n.ID] || 0;
      const c = n.Status === 'down' ? 'down'
        : n.SchedulingEligibility !== 'eligible' || n.Drain ? 'inelig'
        : k > 8 ? 'hot' : k > 3 ? 'mid' : '';
      return `<a class="cell ${c}" href="#/node/${n.ID}"
        title="${esc(n.Name || n.ID.slice(0,8))} · ${esc(n.Status)} · ` +
        `${k} allocs"></a>`;
    }).join('');
    return `<div class="dc"><h3>${esc(dc)} · ${dcs[dc].length}</h3>
            <div class="cells">${cells}</div></div>`;
  }).join('');

  const jobRows = jobs.map(j => row([
    cell(`<a href="#/job/${encodeURIComponent(j.Namespace)}/` +
         `${encodeURIComponent(j.ID)}">${code(esc(j.ID))}</a>`),
    cell(esc(j.Type)), cell(esc(j.Namespace)),
    cell(j.Status, cls(j.Status))]));
  const depRows = deps.map(d => row([
    cell(`<a href="#/job/${encodeURIComponent(d.Namespace||'default')}/` +
         `${encodeURIComponent(d.JobID)}">${code(esc(d.JobID))}</a>`),
    cell('v' + d.JobVersion), cell(d.Status, cls(d.Status))]));
  const svcRows = svcs.flatMap(nsr => (nsr.Services || []).map(s =>
    row([cell(code(esc(s.ServiceName))),
         cell(esc((s.Tags || []).join(', ')))])));
  // the event stream accumulates across re-renders: carry the box over
  const prevEvents = document.getElementById('events')?.innerHTML || '';
  document.getElementById('main').innerHTML =
    sect('Cluster topology', `<div class="topo">${topo}</div>`, true) +
    sect('Jobs', table(['ID','Type','NS','Status'], jobRows)) +
    sect('Deployments', table(['Job','Ver','Status'], depRows)) +
    sect('Services', table(['Service','Tags'], svcRows)) +
    (REGION ? '' :   // the event stream does not region-forward:
                     // showing local events under foreign data lies
     sect('Events (local region)',
          `<div id="events">${prevEvents}</div>`));
}

// ------------------------------------------------------------ job view
async function viewJob(ns, id) {
  const enc = encodeURIComponent(id);
  const encNs = encodeURIComponent(ns);
  const [job, allocs, evals] = await Promise.all([
    get(`/v1/job/${enc}?namespace=${encNs}`),
    get(`/v1/job/${enc}/allocations?namespace=${encNs}`),
    get(`/v1/job/${enc}/evaluations?namespace=${encNs}`)]);
  const groups = (job.TaskGroups || []).map(tg => row([
    cell(code(esc(tg.Name))), cell(tg.Count),
    cell((tg.Tasks || []).map(t => `${esc(t.Name)} (${esc(t.Driver)})`)
      .join(', '))]));
  const allocRows = allocs.map(a => row([
    cell(`<a href="#/alloc/${a.ID}">${code(a.ID.slice(0,8))}</a>`),
    cell(code(esc(a.TaskGroup))),
    cell(`<a href="#/node/${a.NodeID}">${code((a.NodeID||'').slice(0,8))}</a>`),
    cell(a.ClientStatus, cls(a.ClientStatus)),
    cell(a.DesiredStatus, cls(a.DesiredStatus))]));
  const evalRows = evals.map(e => row([
    cell(code(e.ID.slice(0,8))), cell(e.TriggeredBy),
    cell(e.Status, cls(e.Status)),
    cell(esc(e.StatusDescription || ''))]));
  let versions = [];
  try {
    versions = (await get(`/v1/job/${enc}/versions?namespace=${encNs}`))
      .Versions || [];
  } catch (e) { /* older agents */ }
  const vRows = versions.map(v => row([
    cell(code('v' + v.Version)),
    cell(v.Stable ? 'stable' : '', 'dim'),
    cell(v.Version > 0
      ? `<a href="#/diff/${encNs}/${enc}/${v.Version - 1}/${v.Version}">` +
        `diff v${v.Version - 1} → v${v.Version}</a>` : '')]));
  document.getElementById('main').innerHTML =
    sect(`Job ${esc(id)} · ${esc(job.Type)} · v${job.Version} · ` +
         `<span class="${cls(job.Status)}">${job.Status}</span>`,
         table(['Group','Count','Tasks'], groups), true) +
    sect('Allocations',
         table(['ID','Group','Node','Client','Desired'], allocRows), true) +
    sect('Evaluations',
         table(['ID','Trigger','Status',''], evalRows), true) +
    (vRows.length > 1
      ? sect('Versions', table(['Version','','Diff'], vRows), true) : '');
}

// ---------------------------------------------------- job version diff
// Flatten both versions' wire forms and show added/removed/changed
// fields (reference: `nomad job history -p` / plan annotations diff;
// index-churn fields are elided).
function flatten(obj, prefix, out) {
  const SKIP = new Set(['CreateIndex', 'ModifyIndex', 'JobModifyIndex',
                        'SubmitTime', 'Version', 'Status', 'Stable']);
  for (const [k, v] of Object.entries(obj || {})) {
    if (SKIP.has(k)) continue;
    const key = prefix ? `${prefix}.${k}` : k;
    if (v && typeof v === 'object' && !Array.isArray(v)) {
      flatten(v, key, out);
    } else if (Array.isArray(v) && v.length &&
               typeof v[0] === 'object') {
      v.forEach((el2, i) => flatten(el2, `${key}[${i}]`, out));
    } else {
      out[key] = JSON.stringify(v);
    }
  }
  return out;
}

async function viewDiff(ns, id, va, vb) {
  const enc = encodeURIComponent(id);
  const encNs = encodeURIComponent(ns);
  const versions = (await get(
    `/v1/job/${enc}/versions?namespace=${encNs}`)).Versions || [];
  const byV = {};
  for (const v of versions) byV[v.Version] = v;
  const a = byV[va], b = byV[vb];
  if (!a || !b) throw new Error(`version ${!a ? va : vb} not found`);
  const fa = flatten(a, '', {});
  const fb = flatten(b, '', {});
  const lines = [];
  const keys = [...new Set([...Object.keys(fa), ...Object.keys(fb)])]
    .sort();
  for (const k of keys) {
    if (!(k in fa)) {
      lines.push(`<div class="diff-add">+ ${esc(k)} = ${esc(fb[k])}</div>`);
    } else if (!(k in fb)) {
      lines.push(`<div class="diff-del">- ${esc(k)} = ${esc(fa[k])}</div>`);
    } else if (fa[k] !== fb[k]) {
      lines.push(`<div class="diff-del">- ${esc(k)} = ${esc(fa[k])}</div>` +
                 `<div class="diff-add">+ ${esc(k)} = ${esc(fb[k])}</div>`);
    }
  }
  document.getElementById('main').innerHTML =
    sect(`Diff · <a href="#/job/${encNs}/${enc}">${esc(id)}</a> · ` +
         `v${esc(va)} → v${esc(vb)}`,
         `<div class="diff">` +
         (lines.length ? lines.join('')
                       : '<span class="dim">no differences</span>') +
         `</div>`, true);
}

// ---------------------------------------------------------- alloc view
async function viewAlloc(id) {
  const a = await get(`/v1/allocation/${id}?namespace=*`);
  const states = Object.entries(a.TaskStates || {}).map(([name, ts]) => {
    const evs = (ts.Events || []).map(e => row([
      cell(new Date((e.Time || 0) * 1000).toLocaleTimeString()),
      cell(e.Type), cell(esc(e.DisplayMessage || e.Message || ''))]));
    return sect(`Task ${esc(name)} · ` +
      `<span class="${cls(ts.State)}">${ts.State}</span>` +
      (ts.Failed ? ' <span class="bad">failed</span>' : ''),
      table(['Time','Event',''], evs), true);
  }).join('');
  document.getElementById('main').innerHTML =
    sect(`Allocation ${code(a.ID.slice(0,8))} · ` +
         `job <a href="#/job/${encodeURIComponent(a.Namespace)}/` +
         `${encodeURIComponent(a.JobID)}">${code(esc(a.JobID))}</a> · ` +
         `node <a href="#/node/${a.NodeID}">` +
         `${code((a.NodeID||'').slice(0,8))}</a> · ` +
         `<a href="#/exec/${a.ID}">exec terminal</a>`,
         table(['Client','Desired',''], [row([
           cell(a.ClientStatus, cls(a.ClientStatus)),
           cell(a.DesiredStatus, cls(a.DesiredStatus)),
           cell(esc(a.DesiredDescription || ''))])]), true) + states;
}

// -------------------------------------------------------- exec terminal
// INTERACTIVE terminal over the exec-session endpoints (the reference
// streams a PTY over websocket; this surface opens a session —
// POST {Interactive:true} — then pumps stdout via long-poll GETs on
// .../exec/:sid/stream while Enter-submitted lines POST to
// .../exec/:sid/stdin; both directions stream concurrently).  The view
// pauses the 5s auto-refresh so scrollback survives.
async function viewExec(id) {
  PAUSE_REFRESH = true;
  const a = await get(`/v1/allocation/${id}?namespace=*`);
  const tasks = Object.keys(a.TaskStates || {});
  const opts = tasks.map(t => `<option>${esc(t)}</option>`).join('');
  document.getElementById('main').innerHTML =
    sect(`Exec · allocation <a href="#/alloc/${a.ID}">` +
         `${code(a.ID.slice(0,8))}</a> · job ${code(esc(a.JobID))}`,
         `<div id="term"></div>
          <div style="margin-top:.5rem">
            <select id="termtask">${opts}</select>
            <input id="termsh" value="/bin/sh" size="8"
                   title="shell command for the session">
            <button id="termgo">connect</button>
            <input id="termcmd" placeholder="stdin… (Enter to send)"
                   autocomplete="off" disabled>
          </div>`, true);
  const term = document.getElementById('term');
  const input = document.getElementById('termcmd');
  const b64e = s => btoa(String.fromCharCode(...new TextEncoder().encode(s)));
  // ONE streaming decoder: a multi-byte UTF-8 sequence split across two
  // long-poll chunks must not decode to replacement chars
  const dec = new TextDecoder();
  const b64d = s => dec.decode(
    Uint8Array.from(atob(s || ''), c => c.charCodeAt(0)), {stream: true});
  const say = (s, cls2) => {
    const el = document.createElement('div');
    if (cls2) el.className = cls2;
    el.textContent = s;
    term.appendChild(el);
    term.scrollTop = term.scrollHeight;
  };
  say(`tasks: ${tasks.join(', ') || '(none)'} — pick a task, connect`);
  let sid = null, alive = false;
  const base = `/v1/client/allocation/${id}/exec`;
  async function pump() {
    let offset = 0;
    while (alive) {
      try {
        const out = await get(`${base}/${sid}/stream?offset=${offset}`);
        const text = b64d(out.Data);
        if (text) say(text);
        offset = out.Offset ?? offset;
        if (out.Exited) {
          say(`(session exited ${out.ExitCode ?? '?'})`,
              out.ExitCode ? 'bad' : 'dim');
          alive = false; input.disabled = true;
          goBtn.disabled = false;    // allow a fresh session
        }
      } catch (e) { say(String(e), 'bad'); alive = false;
                    goBtn.disabled = false; }
    }
  }
  const goBtn = document.getElementById('termgo');
  goBtn.onclick = async () => {
    goBtn.disabled = true;     // double-click would leak a session and
    try {                      // run two pump loops
      const out = await post(base, {
        Task: document.getElementById('termtask').value,
        Cmd: [document.getElementById('termsh').value, '-i'],
        Interactive: true});
      sid = out.SessionId; alive = true;
      say(`connected (session ${sid.slice(0,8)})`, 'dim');
      input.disabled = false; input.focus();
      pump();
    } catch (e) { say(String(e), 'bad'); goBtn.disabled = false; }
  };
  input.onkeydown = async ev => {
    if (ev.key !== 'Enter' || !alive) return;
    const line = input.value;
    input.value = '';
    say(`> ${line}`, 'dim');
    try {
      await post(`${base}/${sid}/stdin`, {Data: b64e(line + '\n')});
    } catch (e) { say(String(e), 'bad'); }
  };
  window.addEventListener('hashchange', () => {
    alive = false;
    if (sid) fetch(`${base}/${sid}`, {method: 'DELETE'});
  }, {once: true});
}

// ----------------------------------------------------------- node view
async function viewNode(id) {
  const [n, allocs] = await Promise.all([
    get(`/v1/node/${id}`), get(`/v1/node/${id}/allocations`)]);
  const live = allocs.filter(a => a.ClientStatus === 'running'
                               || a.ClientStatus === 'pending');
  const res = n.Resources || {};
  let usedCpu = 0, usedMem = 0;
  for (const a of live) {
    usedCpu += (a.Resources || {}).CPU || 0;
    usedMem += (a.Resources || {}).MemoryMB || 0;
  }
  const bar = (used, cap) => cap ?
    `<div class="bar"><i style="width:${Math.min(100, 100*used/cap)}%"></i>
     </div><span class="dim">${used} / ${cap}</span>` : '';
  const attrRows = Object.entries(n.Attributes || {}).sort()
    .map(([k, v]) => row([cell(code(esc(k))), cell(esc(v))]));
  const allocRows = allocs.map(a => row([
    cell(`<a href="#/alloc/${a.ID}">${code(a.ID.slice(0,8))}</a>`),
    cell(`<a href="#/job/${encodeURIComponent(a.Namespace)}/` +
         `${encodeURIComponent(a.JobID)}">${code(esc(a.JobID))}</a>`),
    cell(a.ClientStatus, cls(a.ClientStatus)),
    cell(a.DesiredStatus, cls(a.DesiredStatus))]));
  document.getElementById('main').innerHTML =
    sect(`Node ${esc(n.Name || '')} ${code(n.ID.slice(0,8))} · ` +
         `${esc(n.Datacenter)} · ` +
         `<span class="${cls(n.Status)}">${n.Status}</span>` +
         (n.Drain ? ' <span class="warn">draining</span>' : ''),
         table(['CPU (MHz)','Memory (MB)'], [row([
           cell(bar(usedCpu, res.CPU)),
           cell(bar(usedMem, res.MemoryMB))])]), true) +
    sect('Allocations',
         table(['ID','Job','Client','Desired'], allocRows)) +
    sect('Attributes', table(['Key','Value'], attrRows));
}

// ------------------------------------------------------- router/events
let PAUSE_REFRESH = false;
async function route() {
  const h = location.hash.replace(/^#\\/?/, '');
  const p = h.split('/').filter(Boolean).map(decodeURIComponent);
  PAUSE_REFRESH = false;
  try {
    if (p[0] === 'job' && p.length >= 3) await viewJob(p[1], p[2]);
    else if (p[0] === 'alloc') await viewAlloc(p[1]);
    else if (p[0] === 'node') await viewNode(p[1]);
    else if (p[0] === 'exec') await viewExec(p[1]);
    else if (p[0] === 'diff' && p.length >= 5)
      await viewDiff(p[1], p[2], +p[3], +p[4]);
    else await viewOverview();
  } catch (e) {
    document.getElementById('main').innerHTML =
      sect('Error', `<span class="bad">${esc(e)}</span>`, true);
  }
}

async function loadRegions() {
  try {
    const regions = await get('/v1/regions');
    const sel = document.getElementById('region');
    sel.innerHTML = '<option value="">local region</option>' +
      regions.map(r => `<option value="${esc(r)}">${esc(r)}</option>`)
        .join('');
    sel.onchange = () => { REGION = sel.value; route(); };
  } catch (e) { /* non-federated agent */ }
}

async function tailEvents() {
  try {
    const resp = await fetch('/v1/event/stream');
    const rd = resp.body.getReader();
    const dec = new TextDecoder();
    let buf = '';
    for (;;) {
      const {value, done} = await rd.read();
      if (done) break;
      buf += dec.decode(value, {stream: true});
      let i;
      while ((i = buf.indexOf('\\n')) >= 0) {
        const line = buf.slice(0, i); buf = buf.slice(i + 1);
        if (!line.trim()) continue;
        const batch = JSON.parse(line);
        const box = document.getElementById('events');
        for (const ev of (batch.Events || [])) {
          if (!box) continue;
          const el = document.createElement('div');
          el.textContent =
            `#${ev.Index} ${ev.Topic}/${ev.Type} ${ev.Key.slice(0,8)}`;
          box.prepend(el);
          while (box.childNodes.length > 60)
            box.removeChild(box.lastChild);
        }
      }
    }
  } catch (e) { /* reconnect below */ }
  setTimeout(tailEvents, 2000);
}

window.addEventListener('hashchange', route);
route();
loadRegions();
setInterval(() => { if (!PAUSE_REFRESH) route(); }, 5000);
tailEvents();
</script>
</body>
</html>
"""
